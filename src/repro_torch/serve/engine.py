"""Serving engine: batched prefill + greedy decode, the port of
``repro.serve.engine``.

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
and in every decode step.
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
its cost is ``warmup_s``, never step time.

Not ported yet (ROADMAP.md queue 1): plan artifacts (``plan_artifact``,
item 7), the degradation ladder of ``_run_step`` and the NaN guard (item
6), tracing, ``serve_stream`` and the scheduler, and sampling with
``temperature > 0``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch import device as device_mod
from repro_torch.launch.steps import StepTimer
from repro_torch.models import model as model_mod


@dataclasses.dataclass
class ServeConfig:
    batch: int = 4
    max_len: int = 256
    temperature: float = 0.0      # 0 = greedy, the only mode ported
    cache_dtype: str = "float32"
    # plan the registry's bucket grid at construction (a no-op unless the
    # model routes its kernels through the registry)
    warmup: bool = True
    # overrides cfg.kernel_plan for this engine ('measure' | 'direct')
    kernel_plan: Optional[str] = None


class Engine:
    def __init__(self, cfg, model, scfg: ServeConfig, *,
                 device: Optional[Union[str, torch.device]] = None):
        if scfg.temperature > 0.0:
            raise NotImplementedError(
                "sampling with temperature > 0 needs the reference's "
                "threefry key chains (ROADMAP.md queue 1, item 4)")
        model_mod.check_supported(cfg)
        if scfg.kernel_plan and scfg.kernel_plan != cfg.kernel_plan:
            cfg = dataclasses.replace(cfg, kernel_plan=scfg.kernel_plan)
        if not cfg.fresh_prefill_kernel:
            cfg = dataclasses.replace(cfg, fresh_prefill_kernel=True)
        self.cfg, self.scfg = cfg, scfg
        self.device = device_mod.resolve(device)
        self.model = model.to(self.device)
        self.cache_dtype = getattr(torch, scfg.cache_dtype)
        self.timer = StepTimer(self.device)
        self.ttft_s: Optional[float] = None
        self.warmup_s = 0.0
        self.warmup_report: List[Dict[str, Any]] = []
        # captured once: warmup(), stats() and the layers (through
        # _serving) use this registry, even if the process default is
        # swapped later
        self._reg = None
        if cfg.kernel_plan == "measure":
            from repro_torch.compiler.registry import default_registry
            self._reg = default_registry()
        if scfg.warmup:
            self.warmup()

    def warmup(self) -> List[Dict[str, Any]]:
        """Plan the registry's bucket grid for this model and shape: one
        request per kernel and bucket up to ``max_len``
        (``transformer.plan_requests(..., cached=True)``), measured now or
        replayed from the compile cache.  The time goes to ``warmup_s``."""
        if self._reg is None:
            return []
        from repro_torch.models import transformer
        param = next(self.model.parameters(), None)
        dtype = torch.promote_types(
            param.dtype if param is not None else torch.float32,
            self.cfg.activation_dtype)
        t0 = time.perf_counter()
        reqs = transformer.plan_requests(
            self.cfg, self.scfg.batch, self.scfg.max_len,
            dtype=str(dtype).replace("torch.", ""), cached=True,
            cache_dtype=self.cache_dtype)
        self.warmup_report = self._reg.warmup(reqs, device=self.device)
        self.warmup_s += time.perf_counter() - t0
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

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens (B, S_prompt) -> (cache, last-position logits (B, V))."""
        tokens = tokens.to(self.device)
        cache = model_mod.init_cache(self.cfg, int(tokens.shape[0]),
                                     self.scfg.max_len, self.cache_dtype,
                                     self.device)
        with self._serving():
            logits, cache = self.timer.run(
                "prefill", model_mod.decode_step, self.cfg, self.model,
                {"tokens": tokens}, cache, last_only=True)
        return cache, logits[:, -1]

    @torch.no_grad()
    def generate(self, prompt_tokens: torch.Tensor, n_new: int,
                 return_logits: bool = False):
        """Greedy generation: (B, n_new) tokens, or with ``return_logits``
        a (tokens, logits) pair where logits is the fp32 (n_new, B, V)
        stack of the distributions each token was chosen from."""
        t_start = time.perf_counter()
        cache, last = self.prefill(prompt_tokens)
        cur = last.argmax(dim=-1)[:, None]
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.ttft_s = time.perf_counter() - t_start
        toks, lgs = [], [last.float()]
        with self._serving():
            for _ in range(n_new):
                toks.append(cur)
                logits, cache = self.timer.run(
                    "decode", model_mod.decode_step, self.cfg, self.model,
                    {"tokens": cur}, cache)
                lgs.append(logits[:, -1].float())
                cur = logits[:, -1].argmax(dim=-1)[:, None]
        out = torch.cat(toks, dim=1)
        if return_logits:
            return out, torch.stack(lgs[:n_new])
        return out

    def stats(self) -> Dict[str, Any]:
        """Time to first token of the last ``generate``, the plan warmup,
        the per-phase cold / steady-state split and the registry's
        hit / miss / fallback counts (None off the registry)."""
        return {
            "ttft_s": self.ttft_s,
            "warmup_s": round(self.warmup_s, 4),
            "plans_warmed": len(self.warmup_report),
            "warmup_failed": sum(1 for r in self.warmup_report
                                 if "error" in r),
            "warmup_measured": sum(1 for r in self.warmup_report
                                   if r.get("measured")
                                   and not r.get("replayed")),
            "phases": self.timer.stats(),
            "registry": self._reg.stats.as_dict() if self._reg is not None
            else None,
        }
