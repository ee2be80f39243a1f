"""Serving launcher: batched greedy generation with the Engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 8 --prompt-len 512 --new 64 --attention-impl pallas

runs on the card (``--arch mamba2-1.3b --ssm-impl pallas`` serves the SSM
family through the SSD kernels; ``--arch deepseek-v2-lite-16b --moe-ragged``
the MoE family through the grouped-GEMM kernel; ``--arch zamba2-2.7b
--attention-impl pallas --ssm-impl pallas`` the hybrid family through all
four serving kernels).  Every decoder-only config of the reference is
served: qwen3-0.6b, qwen2-7b, qwen2.5-14b, granite-3-2b (dense),
mamba2-1.3b (SSM), deepseek-v2-lite-16b and deepseek-v3-671b (MoE; the
latter's 671 B parameters do not fit one card at full depth) and
zamba2-2.7b (hybrid).  ``--kernel-plan measure``
serves those kernels through the plan registry at measured pump factors,
after a warmup that plans the bucket grid;
``--smoke --device cpu``
runs the SMOKE config on the CPU, where every op takes its plain version.
Weights are seeded random draws with the reference init's distributions
(fp32 for ``--smoke``, else bf16, as in ``repro.launch.serve``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import load_arch
from repro_torch.models import convert
from repro_torch.serve.engine import Engine, ServeConfig


def moe_ragged(cfg):
    """The ragged dropless variant of an MoE config: the fields the
    reference's ``benchmarks/serve_report.py:142`` sets."""
    if cfg.moe is None:
        raise ValueError(f"--moe-ragged: {cfg.name} has no MoE layers")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ragged_dropless=True, inference_capacity_factor=0.0))


def route(cfg) -> str:
    """Which kernels serve the config, for a report line."""
    if cfg.family == "ssm":
        return cfg.ssm_impl
    if cfg.family == "hybrid":
        return f"attention {cfg.attention_impl}, SSM {cfg.ssm_impl}"
    if cfg.family == "moe":
        mo = cfg.moe
        ragged = mo.ragged_dropless and mo.inference_capacity_factor <= 0
        return (f"{cfg.attention_impl}, MoE "
                f"{'ragged grouped GEMM' if ragged else 'dense'}")
    return cfg.attention_impl


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--attention-impl", default=None,
                    choices=("xla_chunked", "pallas"),
                    help="override cfg.attention_impl; 'pallas' runs the "
                         "hand-written CUDA attention kernels")
    ap.add_argument("--ssm-impl", default=None, choices=("xla", "pallas"),
                    help="override cfg.ssm_impl; 'pallas' runs the "
                         "hand-written CUDA SSD scan and decode kernels")
    ap.add_argument("--moe-ragged", action="store_true",
                    help="serve the MoE layers dropless through the ragged "
                         "grouped-GEMM kernel (moe.ragged_dropless=True, "
                         "moe.inference_capacity_factor=0)")
    ap.add_argument("--kernel-plan", default=None,
                    choices=("direct", "measure"),
                    help="override cfg.kernel_plan; 'measure' serves the "
                         "kernels through the plan registry")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_arch(args.arch, smoke=args.smoke)
    if args.attention_impl:
        cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    if args.ssm_impl:
        cfg = dataclasses.replace(cfg, ssm_impl=args.ssm_impl)
    if args.moe_ragged:
        cfg = moe_ragged(cfg)
    dev = device_mod.resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = convert.init_params(
        cfg, gen, dev, torch.float32 if args.smoke else torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1))
    scfg = ServeConfig(batch=args.batch,
                       max_len=args.prompt_len + args.new + 1,
                       kernel_plan=args.kernel_plan)
    eng = Engine(cfg, model, scfg, device=dev)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.new)
    dt = time.perf_counter() - t0

    stats = eng.stats()
    dec = stats["phases"].get("decode", {})
    steady = dec.get("steady_mean_s")
    tps = args.batch / steady if steady else float("nan")
    impl = route(cfg)
    print(f"[serve] {cfg.name} on {dev} ({impl}): generated "
          f"{tuple(out.shape)} in {dt:.3f}s wall")
    print(f"[serve] ttft {stats['ttft_s'] * 1e3:.2f} ms; steady-state decode "
          f"{(steady or float('nan')) * 1e3:.3f} ms/step ({tps:.1f} tok/s) "
          f"over {dec.get('steps', 0)} steps")
    if stats["registry"] is not None:
        r = stats["registry"]
        print(f"[serve] warmup {stats['warmup_s']:.2f}s "
              f"({stats['plans_warmed']} plans, "
              f"{stats['warmup_measured']} measured); plan registry: "
              f"prefill {r['prefill']} | decode {r['decode']} | hit_rate "
              f"{r['hit_rate']} fallbacks {r['fallbacks']}")
    print("[serve] first sequence:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
