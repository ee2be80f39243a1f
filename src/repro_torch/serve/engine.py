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

Not ported yet (ROADMAP.md queue 1): the plan registry and warmup, the
degradation ladder of ``_run_step``, tracing, ``serve_stream`` and the
scheduler, and sampling with ``temperature > 0``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Union

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


class Engine:
    def __init__(self, cfg, model, scfg: ServeConfig, *,
                 device: Optional[Union[str, torch.device]] = None):
        if scfg.temperature > 0.0:
            raise NotImplementedError(
                "sampling with temperature > 0 needs the reference's "
                "threefry key chains (ROADMAP.md queue 1, item 4)")
        model_mod.check_supported(cfg)
        if not cfg.fresh_prefill_kernel:
            cfg = dataclasses.replace(cfg, fresh_prefill_kernel=True)
        self.cfg, self.scfg = cfg, scfg
        self.device = device_mod.resolve(device)
        self.model = model.to(self.device)
        self.cache_dtype = getattr(torch, scfg.cache_dtype)
        self.timer = StepTimer(self.device)
        self.ttft_s: Optional[float] = None

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens (B, S_prompt) -> (cache, last-position logits (B, V))."""
        tokens = tokens.to(self.device)
        cache = model_mod.init_cache(self.cfg, int(tokens.shape[0]),
                                     self.scfg.max_len, self.cache_dtype,
                                     self.device)
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
        """Time to first token of the last ``generate`` and the per-phase
        cold / steady-state split."""
        return {"ttft_s": self.ttft_s, "phases": self.timer.stats()}
