"""Deterministic fault-injection harness for the compile→serve path; the
port of ``repro.testing.faults`` (its own copy, the same rules and actions).

The robustness contract — *the optimized path can never be worse than the
unoptimized one, including when it fails* — is only testable if every
failure mode can be triggered on demand, deterministically, in a unit
test.  This module is that trigger.  The port threads named **injection
sites** through its failure-prone seams::

    from repro_torch.testing import faults
    ...
    faults.check("cache.load", path=str(self.path))      # may raise
    text = faults.mangle("cache.json", text)             # may corrupt
    fn = faults.wrap("emission.exec", fn, graph=g.name)  # may NaN outputs

With no rules installed (the production state) each site costs one truthy
check of a module-level list — no locks, no RNG, no allocation.  Tests
install :class:`FaultRule`\\ s scoped by a context manager::

    with faults.inject(faults.FaultRule("cache.load", "io_error")):
        ...   # every cache.load site now raises OSError

Rules are matched by ``fnmatch`` pattern over the site name, optionally
filtered by context attributes (``match={"kernel": "ssd_*"}``), fire
deterministically (``after`` skips the first N matching calls, ``times``
caps total firings) or probabilistically from a **seeded** RNG (``p`` < 1) —
the same seed always yields the same fault schedule.  Every firing counts
``faults.injected`` (with the site and action) through
:mod:`repro_torch.obs`, so a chaos run's injected faults are part of the
same metrics snapshot as the degradations they cause.

Actions
-------
``io_error``      raise :class:`OSError` (cache/file IO sites)
``error``         raise :class:`FaultError` (generic injected failure)
``timeout``       raise :class:`FaultTimeout` (measurement-budget sites)
``truncate``      mangle text/bytes to its first half (torn write)
``garbage``       mangle text to non-JSON bytes (bitrot)
``nan``           wrap: fill every floating ``torch.Tensor`` of the
                  outputs (a tensor, or a tuple / list / dict of them) with
                  NaN, on the tensor's own device (bad compiled kernel)
a callable        escape hatch: called as ``action(site, value, **ctx)`` at
                  mangle/wrap sites, ``action(site, None, **ctx)`` at check
                  sites (raise to inject)

Sites threaded through the port (the README's fault matrix maps each to
its rung and counter):

=======================  ==================================================
``cache.load``           persistent plan-store read (``_read_disk``)
``cache.json``           raw cache JSON text before parsing (mangle)
``cache.save``           plan-store write (``_save``, ``prune``)
``compile.measure``      one autotune candidate measurement (per factor)
``emission.lower``       hopper-backend lowering of one graph
``emission.exec``        execution of a hopper-backend compiled graph (wrap)
``registry.exec``        the call a plan-registry wrapper makes on the
                         serving path (wrap; plans installed under rules)
``engine.decode``        one engine decode step (mid-request failure)
``engine.prefill``       one engine whole-prompt prefill step
``engine.prefill_chunk`` one continuation-prefill chunk (chunked prefill /
                         preemption resume)
``sched.slot_free``      scheduler lane reclamation at request completion
``sched.preempt``        scheduler slot preemption (park + requeue)
``sched.evict_rows``     cache-row eviction of a preempted lane
=======================  ==================================================

The reference's ``tune.lease``, ``artifact.load`` and ``artifact.verify``
sites belong to the offline tuner and plan artifacts, not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import random
from typing import Any, Callable, Dict, List, Optional, Union


class FaultError(RuntimeError):
    """Generic injected failure (the ``error`` action)."""


class FaultTimeout(TimeoutError):
    """Injected measurement/wall-clock timeout (the ``timeout`` action)."""


@dataclasses.dataclass
class FaultRule:
    """One seeded injection rule.

    ``site`` is an ``fnmatch`` pattern over injection-site names;
    ``action`` one of the named actions above or a callable.  ``after``
    skips the first N matching calls, ``times`` caps how often the rule
    fires (None = unlimited), ``p`` fires probabilistically from a RNG
    seeded with ``seed`` (deterministic schedule), and ``match`` filters on
    site context attributes (fnmatch on ``str(value)`` per key; a context
    missing the key does not match).
    """

    site: str
    action: Union[str, Callable]
    times: Optional[int] = None
    after: int = 0
    p: float = 1.0
    seed: int = 0
    match: Optional[Dict[str, str]] = None
    message: str = ""
    # runtime state (not part of the rule identity)
    fired: int = dataclasses.field(default=0, compare=False)
    seen: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def _matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatch(site, self.site):
            return False
        for key, pat in (self.match or {}).items():
            if key not in ctx or not fnmatch.fnmatch(str(ctx[key]), pat):
                return False
        return True

    def should_fire(self, site: str, ctx: Dict[str, Any]) -> bool:
        """Consume one matching call; True when the fault fires on it."""
        if not self._matches(site, ctx):
            return False
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True


# Active rules.  Deliberately a plain module-level list: the zero-rule fast
# path at every injection site is `if not faults._RULES: return`.
_RULES: List[FaultRule] = []


def active() -> bool:
    """True when any fault rule is installed."""
    return bool(_RULES)


def install(*rules: FaultRule) -> None:
    _RULES.extend(rules)


def clear() -> None:
    del _RULES[:]


@contextlib.contextmanager
def inject(*rules: FaultRule):
    """Scope ``rules``: installed on entry, removed (only they) on exit."""
    install(*rules)
    try:
        yield rules
    finally:
        for r in rules:
            try:
                _RULES.remove(r)
            except ValueError:       # a nested clear() already dropped it
                pass


def _count(site: str, action: str, **ctx) -> None:
    # local import: obs is cheap but faults must stay importable from
    # anywhere in the package without cycles
    from repro_torch import obs
    obs.count("faults.injected", site=site, action=action,
              **{k: str(v) for k, v in ctx.items()})


def _raise_for(rule: FaultRule, site: str, ctx: Dict[str, Any]) -> None:
    msg = rule.message or f"injected fault at {site}"
    if rule.action == "io_error":
        raise OSError(msg)
    if rule.action == "timeout":
        raise FaultTimeout(msg)
    if rule.action == "error":
        raise FaultError(msg)
    if callable(rule.action):
        rule.action(site, None, **ctx)
        return
    raise FaultError(f"{msg} (action {rule.action!r})")


def check(site: str, **ctx) -> None:
    """Raising injection site: a no-op unless a matching rule fires, in
    which case the rule's exception is raised (``io_error`` / ``timeout`` /
    ``error`` / callable)."""
    if not _RULES:
        return
    for rule in list(_RULES):
        if rule.should_fire(site, ctx):
            _count(site, str(rule.action), **ctx)
            _raise_for(rule, site, ctx)


def mangle(site: str, value, **ctx):
    """Value-corrupting injection site: returns ``value`` unchanged unless a
    matching rule fires, in which case the corrupted value is returned
    (``truncate`` / ``garbage`` / callable).  Raising actions raise."""
    if not _RULES:
        return value
    for rule in list(_RULES):
        if not rule.should_fire(site, ctx):
            continue
        _count(site, str(rule.action), **ctx)
        if rule.action == "truncate":
            return value[: len(value) // 2]
        if rule.action == "garbage":
            return (b"\x00garbage\x00" if isinstance(value, bytes)
                    else "{not json!")
        if callable(rule.action):
            return rule.action(site, value, **ctx)
        _raise_for(rule, site, ctx)
    return value


def wrap(site: str, fn: Callable, **ctx) -> Callable:
    """Output-corrupting injection site for compiled kernels: wraps ``fn``
    so each *call* consults the rules — ``nan`` replaces every floating
    tensor in the result (a tensor, or a tuple / list / dict of them) with
    NaNs of the same shape, dtype and device; raising actions raise at
    call time.  With no rules installed at wrap time the original ``fn``
    is returned untouched, so the production hot path gains no call-level
    indirection."""
    if not _RULES:
        return fn

    def _nanify(out):
        import torch
        if isinstance(out, torch.Tensor):
            return torch.full_like(out, float("nan")) \
                if out.is_floating_point() else out
        if isinstance(out, dict):
            return {k: _nanify(v) for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(_nanify(v) for v in out)
        return out          # non-tensor leaf: leave it alone

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for rule in list(_RULES):
            if not rule.should_fire(site, ctx):
                continue
            _count(site, str(rule.action), **ctx)
            if rule.action == "nan":
                return _nanify(out)
            if callable(rule.action):
                return rule.action(site, out, **ctx)
            _raise_for(rule, site, ctx)
        return out

    return wrapped


__all__ = ["FaultRule", "FaultError", "FaultTimeout", "active", "install",
           "clear", "inject", "check", "mangle", "wrap"]
