"""Fault-tolerance runtime: failure detection, restart, straggler
mitigation; the port of ``repro.runtime.failover``.

  - :class:`Heartbeat`: cooperative failure detection for the training
    loop.  Workers stamp a step counter; a monitor marks a worker dead
    after ``timeout_s`` without progress.
  - :func:`run_with_recovery`: the restart loop.  It runs train steps and,
    on a failure, restores the newest checkpoint that restores and goes
    on from its step (exactly-once data through the step saved in the
    checkpoint).  One divergence from the reference: a ``KernelError``
    (``kernels._build``: a kernel that does not build, has no case for
    its inputs or fails to launch) propagates instead of restoring, as the
    serving engine's does.  A toolchain fault is not a node loss, and a
    restart would only meet it again.
  - :class:`StragglerPolicy`: per-host pump factors from step-time EWMAs.
    Synchronous data parallelism cannot drop a slow worker, but a slow
    host can take fewer microbatches per synchronization (the gradient
    carries its microbatch count).

  - :func:`elastic_remesh`: restore a checkpoint onto a mesh of another
    shape (another data-parallel degree after a node loss), its
    placements recomputed from the same rule table.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.kernels._build import KernelError


class FailureInjected(RuntimeError):
    """Raised by tests to simulate a node loss mid-training."""


@dataclasses.dataclass
class Heartbeat:
    timeout_s: float = 300.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)
    _step: Dict[int, int] = dataclasses.field(default_factory=dict)

    def stamp(self, worker: int, step: int, now: Optional[float] = None):
        self._last[worker] = now if now is not None else time.time()
        self._step[worker] = step

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [w for w, t in self._last.items() if now - t > self.timeout_s]

    def slowest(self) -> Optional[int]:
        if not self._step:
            return None
        return min(self._step, key=self._step.get)


@dataclasses.dataclass
class StragglerPolicy:
    """Per-host pump-factor rebalancing from step-time EWMAs."""

    base_pump: int = 4
    ewma: float = 0.9
    tolerance: float = 1.3      # hosts slower than 1.3x median get derated
    _t: Dict[int, float] = dataclasses.field(default_factory=dict)

    def observe(self, worker: int, step_time: float):
        prev = self._t.get(worker, step_time)
        self._t[worker] = self.ewma * prev + (1 - self.ewma) * step_time

    def pump_factors(self) -> Dict[int, int]:
        if not self._t:
            return {}
        med = float(np.median(list(self._t.values())))
        out = {}
        for w, t in self._t.items():
            derate = max(1, int(round(t / (med * self.tolerance))))
            out[w] = max(1, self.base_pump // derate)
        return out


def _restore_any(ckpt_root: str, like) -> Optional[tuple]:
    """Restore the newest checkpoint that restores, newest first.  A
    candidate that fails its hash or its restore is counted
    (``failover.ckpt_skipped``) and the next older one is tried: a
    recovery loop must not crash on its own recovery data.  Returns
    ``(tree, extra)``, or None when no candidate restores."""
    for s in sorted(ckpt.available_steps(ckpt_root), reverse=True):
        path = os.path.join(ckpt_root, f"step_{s:08d}")
        if not ckpt.verify(path):
            obs.count("failover.ckpt_skipped", step=str(s), why="hash")
            continue
        try:
            return ckpt.restore(path, like)
        except Exception as e:  # noqa: BLE001 — corrupt payload: try older
            obs.count("failover.ckpt_skipped", step=str(s),
                      why=type(e).__name__)
    return None


def run_with_recovery(train_fn: Callable[[Any, int], Any],
                      init_state: Any,
                      n_steps: int,
                      ckpt_root: str,
                      ckpt_every: int = 10,
                      state_to_tree: Callable = lambda s: s,
                      tree_to_state: Callable = lambda t, like: t,
                      max_restarts: int = 3) -> Any:
    """Run ``train_fn(state, step) -> state`` with checkpoint / restart.

    A failure of ``train_fn`` (an injected one included) restores the
    newest valid checkpoint and resumes at its step; a corrupt newest
    checkpoint falls back to an older one, and with none to a restart
    from ``init_state``.  A ``KernelError`` propagates.
    """
    state = init_state
    step = 0
    restarts = 0
    resumed = _restore_any(ckpt_root, state_to_tree(state))
    if resumed is not None:
        tree, extra = resumed
        state = tree_to_state(tree, state)
        step = extra["step"]

    while step < n_steps:
        try:
            state = train_fn(state, step)
            step += 1
            if step % ckpt_every == 0 or step == n_steps:
                ckpt.save(ckpt_root, step, state_to_tree(state),
                          extra={"step": step})
        except KernelError:
            raise
        except Exception:  # noqa: BLE001 — any other failure: restore
            restarts += 1
            obs.count("failover.restart")
            if restarts > max_restarts:
                raise
            restored = _restore_any(ckpt_root, state_to_tree(state))
            if restored is None:
                state, step = init_state, 0
                continue
            tree, extra = restored
            state = tree_to_state(tree, state)
            step = extra["step"]
    return state


def elastic_remesh(ckpt_dir: str, like_tree, new_mesh, spec_fn):
    """Re-place a checkpoint onto a new mesh (other axis sizes).

    ``spec_fn(tree, mesh) -> shardings`` is the rule table used at
    launch (``launch.sharding.shardings``), so resharding needs no
    per-tensor bookkeeping: the placements are recomputed for the new
    mesh and the restored tensors distributed under them."""
    shardings = spec_fn(like_tree, new_mesh)
    return ckpt.restore_resharded(ckpt_dir, like_tree, new_mesh, shardings)
