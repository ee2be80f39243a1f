"""Training launcher: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 8 --seq 2048 --pump 4

trains on the card at full width (``--shape train_4k`` by default, 4096 x
256, which ``--batch`` / ``--seq`` cut to size); ``--smoke --device cpu``
trains the SMOKE config on the CPU (sequence 64, batch 8 unless given):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 20

Parameters are fp32 under ``--smoke`` and bf16 otherwise, with an fp32
master copy and moments (``optim.adamw``), as in the reference.  ``--pump``
takes an int or ``auto`` (``core.pump_plan.plan_trainer_pump`` at the
H100's constants, one card); ``--ckpt DIR`` checkpoints there and resumes
from it; ``--failover`` stamps a heartbeat every step and derates the
pump by the straggler policy.  The last line reports the loss over the
run, its pump, the steady ms a step (median after the first), tokens/s
and the peak device memory.

``--production-mesh`` trains under the production mesh (16 x 16, or 2 x
16 x 16 with ``--multi-pod``: ``launch.mesh.make_production_mesh``) in a
launcher's world of exactly 256 or 512 ranks (``torchrun`` and the like:
the process group is made from its ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` environment); under any other world the launcher exits
non-zero with ``make_production_mesh``'s message, naming the world it
found and the one it needs.  Without it the run takes no mesh: the one
card, no process group.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch import optim
from repro_torch.configs.base import SHAPES, ShapeConfig, load_arch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train.trainer import TrainConfig, train


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="SMOKE config and a small shape")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--pump", default="1", help="int or 'auto'")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="train under the 16x16 production mesh (a world "
                         "of 256 ranks; 512 with --multi-pod)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh (with "
                         "--production-mesh)")
    ap.add_argument("--failover", action="store_true",
                    help="wire the failover runtime into the loop: per-step "
                         "heartbeat stamping + straggler pump derating")
    ap.add_argument("--heartbeat-timeout", type=float, default=300.0,
                    help="seconds without progress before a worker is "
                         "considered dead (--failover)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    mesh = None
    if args.production_mesh:
        mesh = _production_mesh(args.multi_pod, dev)
    cfg = load_arch(args.arch, smoke=args.smoke)
    shape = SHAPES[args.shape]
    if args.smoke:
        shape = ShapeConfig("smoke", args.seq or 64, args.batch or 8, "train")
    elif args.batch or args.seq:
        shape = ShapeConfig("custom", args.seq or shape.seq_len,
                            args.batch or shape.global_batch, "train")
    pump = args.pump if args.pump == "auto" else int(args.pump)
    optcfg = optim.AdamWConfig(lr=args.lr,
                               warmup_steps=max(args.steps // 10, 1),
                               total_steps=args.steps)
    tcfg = TrainConfig(n_steps=args.steps, pump_factor=pump,
                       ckpt_root=args.ckpt, log_every=1,
                       param_dtype="float32" if args.smoke else "bfloat16")
    heartbeat = straggler = None
    if args.failover:
        from repro_torch.runtime.failover import Heartbeat, StragglerPolicy
        heartbeat = Heartbeat(timeout_s=args.heartbeat_timeout)
        straggler = StragglerPolicy()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = train(cfg, shape, optcfg, tcfg, device=dev,
                heartbeat=heartbeat, straggler=straggler, mesh=mesh)
    wall = time.perf_counter() - t0
    hist = out["history"]
    secs = [h["sec"] for h in hist[1:]]
    step_ms = statistics.median(secs) * 1e3 if secs else None
    tokens = shape.global_batch * shape.seq_len
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 \
        if dev.type == "cuda" else None
    summary = {"loss_first": hist[0]["loss"] if hist else None,
               "loss_last": hist[-1]["loss"] if hist else None,
               "steps": len(hist), "pump": out["pump"], "step_ms": step_ms,
               "tokens_per_s": tokens / step_ms * 1e3 if step_ms else None,
               "peak_gib": peak, "wall_s": wall}
    if heartbeat is not None:
        dead = heartbeat.dead_workers()
        print(f"[failover] heartbeat: {len(heartbeat._step)} worker(s) "
              f"stamped, {len(dead)} dead; straggler pump factors "
              f"{straggler.pump_factors()}")
    if hist:
        ms = f"{step_ms:.1f} ms/step steady" if step_ms else "no steady step"
        tps = f"{summary['tokens_per_s']:.0f} tokens/s" if step_ms else ""
        mem = f"peak {peak:.2f} GiB" if peak is not None else "CPU"
        print(f"[train] done: loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f} over {args.steps} steps "
              f"(pump={out['pump']}); {ms}, {tps}, {mem}")
    return summary


def _production_mesh(multi_pod: bool, dev: torch.device):
    """The production mesh over the launcher's world (the process group
    made from its environment), or exit non-zero with
    ``make_production_mesh``'s message."""
    import torch.distributed as dist
    made = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if made:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        return mesh_mod.make_production_mesh(multi_pod, device=dev)
    except RuntimeError as e:
        if made:
            dist.destroy_process_group()
        sys.exit(f"[train] {e}")


if __name__ == "__main__":
    main()
