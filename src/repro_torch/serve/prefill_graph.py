"""The fresh-cache prefill, captured once per length bucket and replayed as
one CUDA graph.

Enqueued op by op, a batch-1 prefill of deepseek-v2-lite costs the host some
5,000 launches (MLA's chunked attention, the rope, the norms, the MoE
routing and its tile table, 27 layers), which on a card whose host cores
are shared takes as long as the card's own work or longer: the host's speed
then paces the prefill, and with it every scheduler step that holds one.
Under ``cfg.prefill_graph_bucket`` (b > 0) a prefill of S tokens instead
replays one graph captured at ``L = bucket_of(S)``, S rounded up to a
multiple of b (at most the cache's length, :func:`buckets`).

**Padding.**  The call's tokens go into the graph's static (B, L) input, the
L - S positions after them hold token 0, and the graph runs the backbone
(``transformer.decode_hidden``) over a static cache of the caller's shapes.
Attention is causal, so no real position sees the padding after it, and
each token routes alone, so the real positions' hidden states and cache
rows are the unpadded prefill's up to rounding (the products run at L rows,
not S).  After the replay the head projects position S - 1 alone
(``transformer.head_logits``; every position under ``last_only=False``),
the static cache's first S rows are copied into the caller's fresh cache,
and its ``pos`` becomes S: the caller gets what an eager prefill gives.

**When it replays** (:func:`eager_reason`): a bucket > 0; the dense or MoE
family; no mesh; no host check of the logits (``nan_guard`` off, no fault
rules); no MoE layer on the ragged registry route (its group sizes are
read on the host); a fresh cache (an int ``pos`` of 0) whose leaves are
all K/V or MLA rows; and a bucket captured at the call's batch and cache
shapes.  Otherwise the prefill runs eagerly and unpadded, counted as
``engine.prefill_graph_eager`` with its reason (a bucket of 0 counts
nothing).

**Capture** (:meth:`PrefillGraph.warm`, which ``Engine`` runs at
construction on a CUDA device): every bucket up to ``max_len`` at the
engine's batch, the longest first, each after one eager run of its own
shape (kernels, cuBLAS and the MoE tally's tensors are made there, never in
a capture); a capture that raises leaves every prefill eager (counted as
``engine.prefill_graph_capture_failed``).  The graphs share one memory pool: they run one at a time on
one stream and a replay's outputs are read before the next replay.  The
kernels' launch counters and the MoE tally's host counts are put back at
capture and added per replay, as in :mod:`.decode_graph`; the experts-hit
tally is on the card, inside the graph.  Off the card (``capture=False``)
a bucket runs its backbone eagerly into the same static buffers, so the
padding and the copy-out run on the CPU as well.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.testing import faults

from .decode_graph import (IN_PLACE, _layers, add_counts, counts_put_back,
                           registry_moe)


# the cache leaves' position dim: K/V (B, Hkv, T, D), MLA's rows (B, T, .)
TIME_DIM = {"k": 2, "v": 2, "c_kv": 1, "k_rope": 1}


def buckets(bucket: int, max_len: int) -> List[int]:
    """The captured lengths: the multiples of ``bucket`` below ``max_len``,
    then ``max_len``."""
    return list(range(bucket, max_len, bucket)) + [max_len]


def bucket_of(s: int, bucket: int, max_len: int) -> int:
    """The captured length a prefill of ``s`` tokens runs at."""
    return min(-(-s // bucket) * bucket, max_len)


def eager_reason(cfg, cache, *, mesh=None,
                 nan_guard: bool = False) -> Optional[str]:
    """Why a prefill over ``cache`` runs eagerly, or None where a captured
    bucket can serve it (module docstring)."""
    if cfg.prefill_graph_bucket <= 0:
        return "off"
    if cfg.family not in ("dense", "moe"):
        return "family"
    if mesh is not None:
        return "mesh"
    if faults.active():
        return "faults"
    if nan_guard:
        return "nan_guard"
    if registry_moe(cfg):
        return "moe"
    layers = _layers(cache)
    pos = layers[0]["pos"]
    if isinstance(pos, torch.Tensor) or pos != 0:
        return "not_fresh"
    if any(name != "pos" and name not in IN_PLACE
           for layer in layers for name in layer):
        return "state"
    return None


def _sig(cache) -> Tuple:
    """The cache's segments, leaf names, shapes and dtypes."""
    return tuple((seg, tuple((name, tuple(leaf.shape), leaf.dtype)
                             for layer in layers
                             for name, leaf in layer.items()
                             if name != "pos"))
                 for seg, layers in cache.items())


@dataclasses.dataclass
class _Bucket:
    tokens: torch.Tensor               # (B, L) static input
    hidden: torch.Tensor               # (B, L, d) static output
    static: Dict                       # the cache the bucket writes
    run: Callable[[], None]            # the graph's replay
    launched: List[Tuple[object, int]]
    tallied: Dict[str, List[int]]


class PrefillGraph:
    """An engine's fresh-cache prefill: ``model.decode_step``'s signature,
    eager or replayed (module docstring).  ``replays`` counts the
    replays."""

    def __init__(self, device: torch.device, mesh=None,
                 nan_guard: bool = False):
        self.device, self.mesh, self.nan_guard = device, mesh, nan_guard
        self.replays = 0
        self._buckets: Dict[Tuple, _Bucket] = {}

    @torch.no_grad()
    def warm(self, cfg, model, batch: int, max_len: int,
             cache_dtype: torch.dtype, *,
             capture: Optional[bool] = None) -> int:
        """Capture every bucket up to ``max_len`` for prefills of ``batch``
        rows into caches of ``max_len`` and ``cache_dtype``; returns the
        buckets captured (0 where the prefill stays eager).  ``capture``
        defaults to a CUDA device."""
        capture = self.device.type == "cuda" if capture is None else capture
        static = model_mod.init_cache(cfg, batch, max_len, cache_dtype,
                                      self.device)
        if eager_reason(cfg, static, mesh=self.mesh,
                        nan_guard=self.nan_guard) is not None:
            return 0
        t0 = time.perf_counter()
        try:
            n = self._warm(cfg, model, batch, max_len, static, capture)
        except Exception as e:  # noqa: BLE001 — serving must not die
            self._buckets.clear()
            obs.count("engine.prefill_graph_capture_failed",
                      reason=type(e).__name__)
            n = 0
        obs.observe("engine.prefill_graph_warm_s", time.perf_counter() - t0)
        return n

    def _warm(self, cfg, model, batch: int, max_len: int, static: Dict,
              capture: bool) -> int:
        pool = torch.cuda.graph_pool_handle() if capture else None
        sizes = buckets(cfg.prefill_graph_bucket, max_len)
        for n in reversed(sizes):
            tokens = torch.zeros((batch, n), dtype=torch.long,
                                 device=self.device)
            hidden, _ = transformer.decode_hidden(cfg, model, tokens, static)
            rec = {"launched": [], "tallied": {}}
            if capture:
                graph = torch.cuda.CUDAGraph()
                with counts_put_back() as rec:
                    with torch.cuda.graph(graph, pool=pool):
                        hidden, _ = transformer.decode_hidden(
                            cfg, model, tokens, static)
                run = graph.replay
                obs.count("engine.prefill_graph_capture")
            else:
                run = self._eager_run(cfg, model, tokens, hidden, static)
            self._buckets[(batch, n, _sig(static))] = _Bucket(
                tokens, hidden, static, run, rec["launched"],
                rec["tallied"])
        return len(sizes)

    @staticmethod
    def _eager_run(cfg, model, tokens, hidden, static) -> Callable[[], None]:
        def run():
            hidden.copy_(transformer.decode_hidden(cfg, model, tokens,
                                                   static)[0])
        return run

    def __call__(self, cfg, model, batch: Dict, cache, *,
                 last_only: bool = False):
        reason = eager_reason(cfg, cache, mesh=self.mesh,
                              nan_guard=self.nan_guard)
        if reason is None:
            tokens = batch["tokens"]
            b, s = tokens.shape
            n = bucket_of(s, cfg.prefill_graph_bucket,
                          transformer._kv_length(cache))
            got = self._buckets.get((b, n, _sig(cache)))
            if got is not None:
                return self._replay(cfg, model, got, tokens, cache,
                                    last_only)
            reason = "not_captured"
        if reason != "off":
            obs.count("engine.prefill_graph_eager", reason=reason)
            obs.count(f"engine.prefill_graph_eager.{reason}")
        return model_mod.decode_step(cfg, model, batch, cache,
                                     last_only=last_only)

    def _replay(self, cfg, model, got: _Bucket, tokens: torch.Tensor,
                cache, last_only: bool):
        s = tokens.shape[1]
        got.tokens[:, :s].copy_(tokens)
        got.tokens[:, s:].zero_()
        got.run()
        add_counts(got.launched, got.tallied)
        x = got.hidden[:, s - 1:s] if last_only else got.hidden[:, :s]
        logits = transformer.head_logits(cfg, model, x)
        for layer, st in zip(_layers(cache), _layers(got.static)):
            for name, leaf in layer.items():
                if name != "pos":
                    dim = TIME_DIM[name]
                    leaf.narrow(dim, 0, s).copy_(st[name].narrow(dim, 0, s))
        self.replays += 1
        return logits, {seg: [dict(layer, pos=s) for layer in layers]
                        for seg, layers in cache.items()}
