"""The fresh-cache prefill, captured once per length bucket and replayed as
one CUDA graph.

Enqueued op by op, a batch-1 prefill costs the host one launch or more per
op, thousands of them over 27 or 28 layers (some 5,000 for
deepseek-v2-lite: MLA's chunked attention, the MoE routing and its tile
table).  On a card whose host cores are shared that takes as long as the
card's own work or longer: the host's speed then paces the prefill, and
with it every scheduler step that holds one.  So a prefill of S tokens
instead replays one graph captured at ``L = bucket_of(S)``, S rounded up to
a multiple of the bucket b (at most the cache's length, :func:`buckets`).

**The bucket** (:func:`engine_bucket`, which ``Engine`` applies to its
config): ``cfg.prefill_graph_bucket`` where a configuration sets one (b >
0); where it is 0, the reference's default, an engine on a CUDA device
takes ``ENGINE_BUCKET`` and off the card keeps 0, under which every
prefill runs eagerly and nothing is counted.

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
read on the host, reason ``moe``) or on the capacity route (reason
``capacity``: its (E, cap + 1, d) buffer takes cap from the routed rows,
the padding's included, so a capped buffer drops other real tokens than
the unpadded prefill does, and an uncapped one, cap = L·k, is E / k times
the ragged route's rows); a fresh cache (an int ``pos`` of 0) whose
leaves are all K/V or MLA rows; the captured state within
``MEMORY_SHARE`` of the card's memory (:func:`state_bytes`, which sizes
the warming's eager pass too; else reason ``memory``); and a bucket
captured at the call's batch and cache shapes.  Otherwise the prefill runs
eagerly and unpadded, counted as ``engine.prefill_graph_eager`` with its
reason (a bucket of 0 counts nothing).

**Capture** (:meth:`PrefillGraph.warm`, which ``Engine`` runs at
construction on a CUDA device): one eager run at ``max_len`` (kernels,
plans, cuBLAS and the MoE tally's tensors are made there, never in a
capture; every shorter bucket finds them made), then every bucket up to
``max_len`` at the engine's batch, the longest first, each captured with
no eager run of its own; a capture that raises leaves every prefill eager
(counted as ``engine.prefill_graph_capture_failed``).  All buckets read
one static token buffer and write one static hidden-state buffer, each its
first L positions, and their graphs share one memory pool: they run one at
a time on one stream and a replay's outputs are read before the next
replay, so the pool holds one bucket's intermediates.  The kernels' launch
counters and the MoE tally's host counts are put back at capture and added
per replay, as in :mod:`.decode_graph`; the experts-hit tally is on the
card, inside the graph.  Off the card (``capture=False``) a bucket runs its
backbone eagerly into the same static buffers, so the padding and the
copy-out run on the CPU as well.
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
# the bucket an engine on the card gives a configuration that sets none
ENGINE_BUCKET = 128
# the most of the card's memory that warming may take and the captured
# state may keep (state_bytes): a default a deployment's weights and
# caches do not miss
MEMORY_SHARE = 0.02


def engine_bucket(cfg, device: torch.device) -> int:
    """The bucket an engine on ``device`` runs its prefills at: the
    configuration's where it sets one, else ``ENGINE_BUCKET`` on a CUDA
    device and 0 (every prefill eager, counted nowhere) off it."""
    if cfg.prefill_graph_bucket > 0 or device.type != "cuda":
        return cfg.prefill_graph_bucket
    return ENGINE_BUCKET


def buckets(bucket: int, max_len: int) -> List[int]:
    """The captured lengths: the multiples of ``bucket`` below ``max_len``,
    then ``max_len``."""
    return list(range(bucket, max_len, bucket)) + [max_len]


def bucket_of(s: int, bucket: int, max_len: int) -> int:
    """The captured length a prefill of ``s`` tokens runs at."""
    return min(-(-s // bucket) * bucket, max_len)


def state_bytes(cfg, batch: int, max_len: int,
                cache_dtype: torch.dtype) -> int:
    """What warming takes on the card at once, and the captured graphs
    keep: the static cache of ``batch`` rows of ``max_len``, the static
    tokens and hidden states, and one layer's working set at the longest
    bucket (:func:`_layer_bytes`).  An estimate of the tensors, not a
    bound: the allocator's rounding, the cuBLAS workspaces and the graph
    pool's own segments are left out (on an H100 the warming's peak came
    to 0.79-1.15 times it, the pool's reserve to 1.16-1.45 times)."""
    cache = model_mod.init_cache(cfg, batch, max_len, cache_dtype,
                                 torch.device("meta"))
    nbytes = sum(leaf.numel() * leaf.element_size()
                 for layer in _layers(cache) for leaf in layer.values()
                 if isinstance(leaf, torch.Tensor))
    act = cfg.activation_dtype.itemsize
    return nbytes + batch * max_len * (8 + cfg.d_model * act) \
        + batch * _layer_bytes(cfg, max_len)


def _layer_bytes(cfg, n: int) -> int:
    """One batch row's largest set of live tensors in a layer of an
    ``n``-token prefill, fp32 counted at its size: the residual stream,
    its norm and the branch's output (3 d), and the wider of the
    attention and the feed-forward.  Attention: GQA's q, k and v, their
    rope's fp32 copies and result, the output; MLA's q, its key-value
    latent, the decompressed keys and values, the concatenated q and k,
    the output and its chunks; off the flash kernel, the plain route's
    fp32 scores, their mask and weights over one block of keys, for every
    query (GQA, keys over the whole cache) or one block of queries (MLA's
    prefill, which skips the key blocks after its queries).
    Feed-forward: 3 d_ff (the gate's activation, the up product and their
    product); on the ragged MoE route k (4 d + 2 d_expert) (the token
    copies and their padded layout, the gate and up products, then the
    down product, its gather and that gather in fp32) and the routing's
    fp32 logits and probabilities a token, the shared experts' 3 d_expert
    each, and the layout's padding of up to 16 rows an expert."""
    act = cfg.activation_dtype.itemsize
    d, h = cfg.d_model, cfg.n_heads
    block = min(cfg.attn_block_kv, n)
    if cfg.mla is not None:
        m = cfg.mla
        qk, dv = m.nope_head_dim + m.rope_head_dim, m.v_head_dim
        attn = 3 * h * qk + h * (m.nope_head_dim + dv) + 2 * h * dv \
            + 2 * (m.kv_lora_rank + m.rope_head_dim)
        flash = cfg.attention_impl == "pallas" and qk == dv
        score_rows = block
    else:
        hkv, hd = cfg.n_kv_heads, cfg.head_dim_
        attn = (h + 2 * hkv) * hd + 8 * (h + hkv) * hd // act + h * hd
        flash = cfg.attention_impl == "pallas"
        score_rows = n
    ffn, fixed = 3 * cfg.d_ff, 0
    mo = cfg.moe
    if mo is not None:
        de = mo.d_expert
        ffn = max(ffn, mo.top_k * (4 * d + 2 * de) + 8 * mo.n_experts // act
                  + 3 * mo.n_shared_experts * de)
        fixed = mo.n_experts * 16 * (d + 2 * de) * act
    nbytes = n * (3 * d + max(attn, ffn)) * act + fixed
    if not flash:
        nbytes += 3 * 4 * h * score_rows * block
    return nbytes


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
    mo = cfg.moe
    if mo is not None and (not mo.ragged_dropless
                           or mo.inference_capacity_factor > 0):
        return "capacity"
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
    run: Callable[[], None]            # the graph's replay
    launched: List[Tuple[object, int]]
    tallied: Dict[str, List[int]]


class PrefillGraph:
    """An engine's fresh-cache prefill: ``model.decode_step``'s signature,
    eager or replayed (module docstring).  ``replays`` counts the
    replays; ``refused`` is ``'memory'`` where :meth:`warm` found the
    captured state too large for the card."""

    def __init__(self, device: torch.device, mesh=None,
                 nan_guard: bool = False):
        self.device, self.mesh, self.nan_guard = device, mesh, nan_guard
        self.replays = 0
        self.refused: Optional[str] = None
        self._buckets: Dict[Tuple, _Bucket] = {}
        self._static: Optional[Dict] = None
        self._tokens = self._hidden = None   # (B, max_len), (B, max_len, d)

    @torch.no_grad()
    def warm(self, cfg, model, batch: int, max_len: int,
             cache_dtype: torch.dtype, *, capture: Optional[bool] = None,
             card_bytes: Optional[int] = None) -> int:
        """Capture every bucket up to ``max_len`` for prefills of ``batch``
        rows into caches of ``max_len`` and ``cache_dtype``; returns the
        buckets captured (0 where the prefill stays eager).  ``capture``
        defaults to a CUDA device, ``card_bytes`` to its memory (no limit
        off the card)."""
        capture = self.device.type == "cuda" if capture is None else capture
        shapes = model_mod.init_cache(cfg, batch, max_len, cache_dtype,
                                      torch.device("meta"))
        if eager_reason(cfg, shapes, mesh=self.mesh,
                        nan_guard=self.nan_guard) is not None:
            return 0
        if card_bytes is None and self.device.type == "cuda":
            card_bytes = torch.cuda.get_device_properties(
                self.device).total_memory
        if card_bytes is not None and state_bytes(
                cfg, batch, max_len, cache_dtype) > MEMORY_SHARE * card_bytes:
            self.refused = "memory"
            return 0
        t0 = time.perf_counter()
        try:
            n = self._warm(cfg, model, batch, max_len, cache_dtype, capture)
        except Exception as e:  # noqa: BLE001 — serving must not die
            self._buckets.clear()
            self._static = self._tokens = self._hidden = None
            obs.count("engine.prefill_graph_capture_failed",
                      reason=type(e).__name__)
            n = 0
        obs.observe("engine.prefill_graph_warm_s", time.perf_counter() - t0)
        return n

    def _warm(self, cfg, model, batch: int, max_len: int,
              cache_dtype: torch.dtype, capture: bool) -> int:
        self._static = model_mod.init_cache(cfg, batch, max_len, cache_dtype,
                                            self.device)
        self._tokens = torch.zeros((batch, max_len), dtype=torch.long,
                                   device=self.device)
        hidden, _ = transformer.decode_hidden(cfg, model, self._tokens,
                                              self._static)
        self._hidden = torch.empty_like(hidden)
        pool = torch.cuda.graph_pool_handle() if capture else None
        sizes = buckets(cfg.prefill_graph_bucket, max_len)
        sig = _sig(self._static)
        for n in reversed(sizes):
            rec = {"launched": [], "tallied": {}}
            if capture:
                graph = torch.cuda.CUDAGraph()
                with counts_put_back() as rec:
                    with torch.cuda.graph(graph, pool=pool):
                        self._backbone(cfg, model, n)
                run = graph.replay
                obs.count("engine.prefill_graph_capture")
            else:
                def run(n=n):
                    self._backbone(cfg, model, n)
            self._buckets[(batch, n, sig)] = _Bucket(run, rec["launched"],
                                                     rec["tallied"])
        return len(sizes)

    def _backbone(self, cfg, model, n: int) -> None:
        """The backbone over the first ``n`` static tokens, into the first
        ``n`` rows of the static hidden states and cache."""
        self._hidden[:, :n].copy_(transformer.decode_hidden(
            cfg, model, self._tokens[:, :n], self._static)[0])

    def __call__(self, cfg, model, batch: Dict, cache, *,
                 last_only: bool = False):
        reason = self.refused or eager_reason(cfg, cache, mesh=self.mesh,
                                              nan_guard=self.nan_guard)
        if reason is None:
            tokens = batch["tokens"]
            b, s = tokens.shape
            n = bucket_of(s, cfg.prefill_graph_bucket,
                          transformer._kv_length(cache))
            got = self._buckets.get((b, n, _sig(cache)))
            if got is not None:
                return self._replay(cfg, model, got, tokens, n, cache,
                                    last_only)
            reason = "not_captured"
        if reason != "off":
            obs.count("engine.prefill_graph_eager", reason=reason)
            obs.count(f"engine.prefill_graph_eager.{reason}")
        return model_mod.decode_step(cfg, model, batch, cache,
                                     last_only=last_only)

    def _replay(self, cfg, model, got: _Bucket, tokens: torch.Tensor,
                n: int, cache, last_only: bool):
        s = tokens.shape[1]
        self._tokens[:, :s].copy_(tokens)
        self._tokens[:, s:n].zero_()
        got.run()
        add_counts(got.launched, got.tallied)
        x = self._hidden[:, s - 1:s] if last_only else self._hidden[:, :s]
        logits = transformer.head_logits(cfg, model, x)
        for layer, st in zip(_layers(cache), _layers(self._static)):
            for name, leaf in layer.items():
                if name != "pos":
                    dim = TIME_DIM[name]
                    leaf.narrow(dim, 0, s).copy_(st[name].narrow(dim, 0, s))
        self.replays += 1
        return logits, {seg: [dict(layer, pos=s) for layer in layers]
                        for seg, layers in cache.items()}
