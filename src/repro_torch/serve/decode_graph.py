"""The continuous-batching decode step, captured once and replayed as one
CUDA graph.

A decode step over the scheduler's per-slot cache
(``init_cache(per_slot_pos=True)``) has the same shapes every step: ``(B,
1)`` tokens, a ``(B,)`` int32 ``pos`` on the card that no layer reads on
the host, and K/V leaves written in place.  Enqueued op by op it costs the
host a few dozen launches a layer; replayed it costs one graph launch.

**When it replays** (:func:`eager_reason`, from what the call observes):
the engine's device is a CUDA device; ``pos`` is a per-slot tensor; no
mesh; no host check of the logits (``nan_guard`` off, no fault rules); no
MoE layer on the ragged registry route (``kernel_plan='measure'`` with
``ragged_dropless`` and ``inference_capacity_factor <= 0``: its group
sizes are read on the host, reason ``moe``; the direct ragged route
builds its tile table on the card and the capacity route reads nothing
back, so both replay); and every cache leaf is
``pos`` or one the step writes in place (``k``, ``v``, MLA's ``c_kv`` and
``k_rope``).  An SSM state or conv window comes back as a new tensor, so
SSM and hybrid caches stay eager, as does ``generate`` (an int ``pos``).
Each eager step counts ``engine.decode_graph_eager`` with its reason, and
``engine.decode_graph_eager.<reason>``.

**Capture.**  A graph is keyed on the batch, the dtypes, and the shapes
and data pointers of the in-place leaves.  The first step of a key runs
eagerly as the real step (``first_step``): it builds kernels and measures
registry plans, which no capture may do.  The next step of that key
captures (``torch.cuda.graph``; nothing executes, so no row is written
twice) and then replays, counted as ``engine.decode_graph_capture``.  One
graph is held at a time, with no reference to the cache: a weak reference
to the key's first leaf drops the graph and its memory pool when the
cache is freed, so a new scheduler's cache is captured anew.  A capture
that raises leaves its key eager for good (``capture_failed``; counted
once as ``engine.decode_graph_capture_failed``).

**Static buffers.**  A replay copies the call's tokens and layer 0's
``pos`` (every layer's ``pos`` is one tensor after a step, and rows are
inserted into each alike) into the graph's inputs, replays, and returns
clones of the logits and of the next ``pos``, which the next replay would
overwrite, over the caller's own K/V leaves.  The caller's ``pos`` is left
as it was, so a replay that raises re-runs on the engine's bottom rung
from the caller's cache, as an eager step does.  Rows that
``insert_rows`` or an eviction write between steps are in the leaves the
graph reads.

**Launch counters.**  The capture leaves every
``repro_torch.kernels.<kernel>.launches`` where it was, and each replay
adds the launches the capture recorded: the counters tell the launches
the card ran, as on the eager path.  The MoE layers' host counts
(``models.moe.TALLY``: calls, routed and buffer rows) are put back and
added per replay alike; their experts-hit tally is on the card, inside
the graph.
"""
from __future__ import annotations

import contextlib
import importlib
import pkgutil
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.testing import faults

# cache leaves a decode step writes in place: the K/V rows and MLA's
# compressed rows; ``pos`` and an SSM's state and conv window come back new
IN_PLACE = frozenset(("k", "v", "c_kv", "k_rope"))


def _layers(cache) -> List[Dict]:
    """Every per-layer cache dict (an enc-dec cache is one list)."""
    segs = cache.values() if isinstance(cache, dict) else (cache,)
    return [layer for seg in segs for layer in seg]


def _with_pos(cache, pos: torch.Tensor):
    """``cache``'s structure over its own leaves, every ``pos`` replaced."""
    return {seg: [dict(layer, pos=pos) for layer in layers]
            for seg, layers in cache.items()}


def _launch_counters() -> list:
    """The kernel modules that count their launches."""
    from repro_torch import kernels
    mods = (importlib.import_module(f"{kernels.__name__}.{m.name}")
            for m in pkgutil.iter_modules(kernels.__path__))
    return [m for m in mods if isinstance(getattr(m, "launches", None), int)]


def registry_moe(cfg) -> bool:
    """An MoE layer on the ragged registry route, which reads its group
    sizes on the host."""
    mo = cfg.moe
    return mo is not None and cfg.kernel_plan == "measure" \
        and mo.ragged_dropless and mo.inference_capacity_factor <= 0


@contextlib.contextmanager
def counts_put_back():
    """Around a capture: yields a dict that gets, at the block's end, the
    kernels' launch counts (``launched``: (module, n) pairs) and the MoE
    tally's host counts (``tallied``: phase -> deltas) the block added,
    and puts both counters back where they were."""
    counters = _launch_counters()
    before = [m.launches for m in counters]
    tally = {p: list(h) for p, h in moe_mod.TALLY.host.items()}
    rec: Dict = {}
    try:
        yield rec
    finally:
        rec["launched"] = [(m, m.launches - n)
                           for m, n in zip(counters, before)
                           if m.launches != n]
        for m, n in zip(counters, before):
            m.launches = n
        rec["tallied"] = {p: [a - b for a, b in zip(h, tally[p])]
                          for p, h in moe_mod.TALLY.host.items()
                          if h != tally[p]}
        for p, h in moe_mod.TALLY.host.items():
            h[:] = tally[p]


def add_counts(launched, tallied) -> None:
    """A replay's share of the counters: what its capture put back."""
    for m, n in launched:
        m.launches += n
    for p, d in tallied.items():
        h = moe_mod.TALLY.host[p]
        h[:] = [a + b for a, b in zip(h, d)]


def eager_reason(cfg, cache, *, device: torch.device, mesh=None,
                 nan_guard: bool = False) -> Optional[str]:
    """Why a decode step over ``cache`` on ``device`` runs eagerly, or
    None where it can replay a captured graph (module docstring)."""
    if device.type != "cuda":
        return "device"
    layers = _layers(cache)
    pos = layers[0]["pos"]
    if not isinstance(pos, torch.Tensor) or pos.dim() != 1:
        return "int_pos"
    if mesh is not None:
        return "mesh"
    if faults.active():
        return "faults"
    if nan_guard:
        return "nan_guard"
    if registry_moe(cfg):
        return "moe"
    if any(name != "pos" and name not in IN_PLACE
           for layer in layers for name in layer):
        return "state"
    return None


def count_eager(reason: str) -> None:
    obs.count("engine.decode_graph_eager", reason=reason)
    # counters carry no attrs into the snapshot: the reason-named one does
    obs.count(f"engine.decode_graph_eager.{reason}")


def _key(tokens: torch.Tensor, layers: List[Dict]) -> Tuple:
    return (tuple(tokens.shape), tokens.dtype, layers[0]["pos"].dtype,
            tuple((leaf.data_ptr(), tuple(leaf.shape), leaf.dtype)
                  for layer in layers for name, leaf in layer.items()
                  if name != "pos"))


class DecodeGraph:
    """An engine's decode step: ``model.decode_step``'s signature, eager
    or replayed (module docstring).  ``replays`` counts the replays."""

    def __init__(self, device: torch.device, mesh=None,
                 nan_guard: bool = False):
        self.device, self.mesh, self.nan_guard = device, mesh, nan_guard
        self.replays = 0
        self._failed = set()
        self._drop()

    def _drop(self) -> None:
        """Forget the held key and graph (its pool is freed with it)."""
        self._key = self._anchor = self._graph = None
        self._tokens = self._pos = self._logits = self._next_pos = None
        self._launched: List[Tuple[object, int]] = []
        self._tallied: Dict[str, List[int]] = {}

    def _hold(self, key: Tuple, first: torch.Tensor) -> None:
        """Remember ``key`` for a capture at its next step; the graph goes
        when ``first``, the key's first leaf, is freed."""
        self._drop()
        me = weakref.ref(self)

        def freed(ref):
            g = me()
            if g is not None and g._anchor is ref:
                g._drop()

        self._key, self._anchor = key, weakref.ref(first, freed)

    def __call__(self, cfg, model, batch: Dict, cache):
        reason = eager_reason(cfg, cache, device=self.device,
                              mesh=self.mesh, nan_guard=self.nan_guard)
        if reason is None:
            tokens, layers = batch["tokens"], _layers(cache)
            key = _key(tokens, layers)
            first = next(leaf for name, leaf in layers[0].items()
                         if name != "pos")
            held = key == self._key and self._anchor() is first
            if key in self._failed:
                reason = "capture_failed"
            elif held and self._graph is None:
                try:
                    self._capture(cfg, model, tokens, cache)
                except Exception as e:  # noqa: BLE001 — serving must not die
                    self._drop()
                    self._failed.add(key)
                    obs.count("engine.decode_graph_capture_failed",
                              reason=type(e).__name__)
                    reason = "capture_failed"
                else:
                    return self._replay(tokens, cache, layers)
            elif held:
                return self._replay(tokens, cache, layers)
            else:
                self._hold(key, first)
                reason = "first_step"
        count_eager(reason)
        return model_mod.decode_step(cfg, model, batch, cache)

    def _capture(self, cfg, model, tokens: torch.Tensor, cache) -> None:
        """Capture the step on static copies of the tokens and of layer 0's
        ``pos`` over the cache's own in-place leaves; the kernels' launch
        counters are put back and their capture's counts kept."""
        self._tokens = tokens.clone()
        self._pos = _layers(cache)[0]["pos"].clone()
        graph = torch.cuda.CUDAGraph()
        with counts_put_back() as rec:
            with torch.cuda.graph(graph):
                logits, new = model_mod.decode_step(
                    cfg, model, {"tokens": self._tokens},
                    _with_pos(cache, self._pos))
        self._graph, self._logits = graph, logits
        self._next_pos = _layers(new)[0]["pos"]
        self._launched, self._tallied = rec["launched"], rec["tallied"]
        obs.count("engine.decode_graph_capture")

    def _replay(self, tokens: torch.Tensor, cache, layers: List[Dict]):
        self._tokens.copy_(tokens)
        self._pos.copy_(layers[0]["pos"])
        self._graph.replay()
        add_counts(self._launched, self._tallied)
        self.replays += 1
        return self._logits.clone(), _with_pos(cache,
                                               self._next_pos.clone())
