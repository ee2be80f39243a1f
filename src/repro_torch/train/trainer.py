"""Training loop: the pumped train step, mixed precision, checkpoints,
failure recovery and metrics; the port of ``repro.train.trainer``.

The trainer is where the paper's transformation meets the optimizer:
``TrainConfig.pump_factor`` M sets how many dependent microbatch
iterations (the fast domain) feed one gradient synchronization and
update (the wide transaction, ``launch.steps.make_train_step``).
``pump_factor='auto'`` asks ``core.pump_plan.plan_trainer_pump``, at the
H100's constants, for the factor that keeps the collective under 10 % of
compute.  On one card there is no collective to hide, so the factor shows
up as memory instead: M microbatches of B / M hold 1 / M of the
activations (qwen3-0.6b's fp32 logits at B 8 x 2048: 9.96 GB at M 1,
2.49 GB a microbatch at M 4) for the same work per update.

Training runs the plain PyTorch routes, as the reference trains on its
plain ones: the hand-written kernels have no backward and refuse tensors
that require grad (``kernels.ops``).  Runs on the card unless
``device='cpu'``.

``mesh=`` (``launch.mesh``) trains under the rule table: ``'auto'`` plans
for the mesh's chips and data-parallel degree, the parameters and the
optimizer state are placed under ``launch.steps.train_shardings`` and
every batch under its batch placements, and checkpoints are saved whole
and restored onto the state's placements.  ``mesh=None`` (the default;
the reference's is ``make_host_mesh()``) is the one-card path as it
was: no process group, no DTensor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import device as device_mod
from repro_torch import obs, optim
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.pump_plan import plan_trainer_pump
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding as shard_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import convert


@dataclasses.dataclass
class TrainConfig:
    n_steps: int = 100
    pump_factor: Any = 1              # int or "auto"
    param_dtype: str = "float32"
    ckpt_root: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt_state: optim.AdamWState
    step: int = 0

    def tree(self) -> Dict:
        """What a checkpoint holds: the parameters and the optimizer state,
        by name."""
        return {"params": self.model.state_dict(),
                "opt_state": self.opt_state.tree()}

    def load(self, tree: Dict) -> None:
        """Copies a checkpoint's tree into the model and the optimizer
        state, in place."""
        with torch.no_grad():
            self.model.load_state_dict(tree["params"], strict=True)
            own = self.opt_state.tree()
            for key in ("master", "m", "v"):
                for name, t in tree["opt_state"][key].items():
                    own[key][name].copy_(t)
            self.opt_state.step.copy_(tree["opt_state"]["step"])


def resolve_pump(cfg: ModelConfig, shape: ShapeConfig, pump,
                 n_chips: int = 1, dp_degree: int = 1) -> int:
    """An int stays; ``'auto'`` plans from the fp32 gradient's bytes and
    the step's 6 · active params · tokens FLOPs (one card: ``n_chips=1,
    dp_degree=1``)."""
    if pump != "auto":
        return int(pump)
    grad_bytes = cfg.param_count() * 4
    tokens = shape.global_batch * shape.seq_len
    step_flops = 6.0 * cfg.active_param_count() * tokens
    return plan_trainer_pump(grad_bytes, step_flops, n_chips, dp_degree)


def make_trainer(cfg: ModelConfig, shape: ShapeConfig,
                 optcfg: optim.AdamWConfig = optim.AdamWConfig(),
                 tcfg: TrainConfig = TrainConfig(), device=None,
                 batch_override: Optional[int] = None,
                 model: Optional[torch.nn.Module] = None, mesh=None):
    """Returns (init_fn, step_fn, data_iter, pump).  ``init_fn(seed)``
    builds the state from ``model`` when given (trained in place, in its
    own dtype), else seeded weights (``convert.init_params``) in
    ``tcfg.param_dtype``; under ``mesh`` the state is placed under
    ``train_shardings`` and each batch under its placements."""
    dev = device_mod.resolve(device)
    if mesh is None:
        pump = resolve_pump(cfg, shape, tcfg.pump_factor)
    else:
        pump = resolve_pump(cfg, shape, tcfg.pump_factor, mesh.size(),
                            mesh_mod.dp_degree(mesh))
    batch = batch_override or shape.global_batch
    if batch % pump:
        raise ValueError(f"pump factor {pump} does not divide the global "
                         f"batch {batch}")
    pdt = getattr(torch, tcfg.param_dtype)
    step = steps_mod.make_train_step(cfg, optcfg, pump)
    if mesh is not None:
        (p_sh, o_sh, b_sh), _, _ = steps_mod.train_shardings(
            cfg, optcfg, mesh, shape, pdt, pump)

    def init_fn(seed: int) -> TrainState:
        m = model
        if m is None:
            m = convert.init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed), dev, pdt)
        m.requires_grad_(True)
        opt = optim.init(optcfg, m)
        if mesh is not None:
            shard_mod.place(m, mesh, p_sh)
            opt = optim.AdamWState(**shard_mod.place(
                opt.tree(), mesh, o_sh.tree()))
        return TrainState(m, opt, 0)

    def step_fn(state: TrainState, batch) -> tuple:
        if mesh is not None:
            batch = shard_mod.place(batch, mesh, b_sh)
        metrics = step(state.model, state.opt_state, batch)
        state.step += 1
        return state, metrics

    data = DataIterator(cfg, shape, DataConfig(seed=tcfg.seed),
                        batch_override=batch_override, pump_factor=pump,
                        device=dev)
    return init_fn, step_fn, data, pump


def _worker() -> int:
    """This process's rank (0 without a process group)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def train(cfg: ModelConfig, shape: ShapeConfig,
          optcfg: optim.AdamWConfig = optim.AdamWConfig(),
          tcfg: TrainConfig = TrainConfig(), device=None,
          batch_override: Optional[int] = None, log: Callable = print,
          heartbeat=None, straggler=None,
          model: Optional[torch.nn.Module] = None, mesh=None
          ) -> Dict[str, Any]:
    """Full driver: init, resume from ``latest_valid`` (the state and the
    data stream's step), the loop, checkpoints.  Returns ``history`` (a
    row per logged step: loss, grad norm, lr, seconds), ``final_state``
    and ``pump``.

    ``heartbeat`` (``runtime.failover.Heartbeat``) gets this worker's step
    after every update; ``straggler`` (``StragglerPolicy``) observes each
    step's wall time and derates the pump factor from its EWMAs, published
    as ``train.pump_derate`` (counted when it moves) and
    ``train.pump_derated`` (a gauge).  A checkpoint is written every
    ``ckpt_every`` steps and at the end (unless the last step just wrote
    it: the reference writes the same state twice).
    """
    init_fn, step_fn, data, pump = make_trainer(
        cfg, shape, optcfg, tcfg, device, batch_override, model, mesh)
    state = init_fn(tcfg.seed)
    worker = _worker()
    pump_derated = pump

    if tcfg.ckpt_root:
        latest = ckpt_mod.latest_valid(tcfg.ckpt_root)
        if latest:
            like = state.tree()
            if mesh is None:
                tree, extra = ckpt_mod.restore(latest, like)
            else:
                tree, extra = ckpt_mod.restore_resharded(
                    latest, like, mesh, shard_mod.placements_of(like))
            state.load(tree)
            state.step = extra["step"]
            data.step = extra["data_step"]
            log(f"[trainer] resumed from {latest} at step {state.step}")

    def save():
        ckpt_mod.save(tcfg.ckpt_root, state.step, state.tree(),
                      extra={"step": state.step, "data_step": data.step})

    if straggler is not None:
        # the policy derates from the resolved pump factor ('auto' is
        # resolved only in make_trainer)
        straggler.base_pump = pump
    history = []
    saved = None
    t_last = t_step = time.time()
    while state.step < tcfg.n_steps:
        batch = next(data)
        state, metrics = step_fn(state, batch)
        if heartbeat is not None:
            heartbeat.stamp(worker, state.step)
        if straggler is not None:
            if next(state.model.parameters()).is_cuda:
                torch.cuda.synchronize()
            now = time.time()
            straggler.observe(worker, now - t_step)
            t_step = now
            derated = straggler.pump_factors().get(worker, pump_derated)
            if derated != pump_derated:
                log(f"[trainer] straggler policy derated pump "
                    f"{pump_derated} -> {derated} (worker {worker})")
                obs.count("train.pump_derate", frm=str(pump_derated),
                          to=str(derated))
                pump_derated = derated
            obs.gauge("train.pump_derated", pump_derated)
        if state.step % tcfg.log_every == 0 or state.step == tcfg.n_steps:
            loss = float(metrics["loss"])
            dt = time.time() - t_last
            t_last = time.time()
            history.append({"step": state.step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]), "sec": dt})
            log(f"[trainer] step {state.step:5d} loss {loss:.4f} "
                f"gnorm {history[-1]['grad_norm']:.3f} "
                f"lr {history[-1]['lr']:.2e} ({dt:.1f}s) pump={pump}")
        if tcfg.ckpt_root and state.step % tcfg.ckpt_every == 0:
            save()
            saved = state.step
    if tcfg.ckpt_root and saved != state.step:
        save()
    return {"history": history, "final_state": state, "pump": pump}
