"""Serving launcher: batched generation with the Engine, greedy or
sampled (``--temperature T`` draws on the reference's threefry key chain).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 8 --prompt-len 512 --new 64 --attention-impl pallas

runs on the card (``--arch mamba2-1.3b --ssm-impl pallas`` serves the SSM
family through the SSD kernels; ``--arch deepseek-v2-lite-16b --moe-ragged``
the MoE family through the grouped-GEMM kernel; ``--arch zamba2-2.7b
--attention-impl pallas --ssm-impl pallas`` the hybrid family through all
four serving kernels).  Every config of the reference is served:
qwen3-0.6b, qwen2-7b, qwen2.5-14b, granite-3-2b (dense), mamba2-1.3b
(SSM), deepseek-v2-lite-16b and deepseek-v3-671b (MoE; the latter's 671 B
parameters do not fit one card at full depth), zamba2-2.7b (hybrid), and
the enc-dec and VLM families as the reference serves them: ``--arch
whisper-base`` draws seeded frames (batch, encoder_seq, d_model) for the
stub frontend, encodes them outside the engine and generates over the
encoder output; ``--arch internvl2-2b`` is served text-only (no patches),
the dense backbone alone.  ``--kernel-plan measure`` serves those kernels through the plan registry at measured pump factors,
after a warmup that plans the bucket grid, and ``--plan-artifact PATH``
warm-starts that warmup from a tuner fleet's artifact
(``python -m repro_torch.launch.tune``): its verified plans replay with
zero measurements;
``--smoke --device cpu``
runs the SMOKE config on the CPU, where every op takes its plain version.
Weights are seeded random draws with the reference init's distributions
(fp32 for ``--smoke``, else bf16, as in ``repro.launch.serve``).

Stream mode, as the reference's: ``--arrival-rate R`` drains a seeded
synthetic trace of ``--requests`` requests (prompts of ``--prompt-len`` and
half of it, ``--new`` tokens each; geometric gaps for R < 1, packed
overload arrivals for R > 1) through ``Engine.serve_stream`` with
``--max-slots`` decode lanes (default ``--batch``), and prints tokens/s,
slot occupancy, queue waits and TTFT (each request's from its submit, or
its arrival step where that comes later, so it holds the queue wait).  ``--prefill-chunk-tokens``,
``--preempt``, ``--max-queue`` and ``--deadline-ms`` are the overload
controls; a shed request is reported on a ``[serve] SHED:`` line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu --arrival-rate 0.5 --max-slots 4 \
        --requests 8 --prompt-len 8 --new 4

Observability, as the reference's: ``--trace PATH`` enables tracing and
writes the run's Chrome trace to PATH (open at ui.perfetto.dev),
``--metrics`` prints the metrics snapshot after the run, and ``--profile
DIR`` brackets ``generate`` (or the stream) in ``obs.profile``, a
``torch.profiler`` capture written to DIR.  A run that degraded a step or
quarantined a plan prints a ``[serve] DEGRADED:`` line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --trace build/t.json --metrics
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch import obs
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
    if cfg.family == "encdec":
        return (f"encoder and decoder self-attention {cfg.attention_impl}, "
                f"cross-attention xla_chunked")
    if cfg.family == "vlm":
        return f"{cfg.attention_impl}, text only"
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


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 is greedy; above 0 samples with the "
                         "reference's key chain from PRNGKey(0)")
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
    ap.add_argument("--plan-artifact", default=None, metavar="PATH",
                    help="warm-start from a published plan artifact "
                         "(python -m repro_torch.launch.tune): verified "
                         "entries replay with zero autotune measurements; "
                         "rejected or missing entries re-measure locally")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--arrival-rate", type=float, default=None, metavar="R",
                    help="stream mode: drain a synthetic arrival trace "
                         "through the continuous-batching scheduler "
                         "(geometric gaps for R < 1; R > 1 packs overload "
                         "arrivals)")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="decode lanes in stream mode (default: --batch)")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests in the stream mode's trace")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    metavar="T",
                    help="chunked prefill: at most T prefill tokens a "
                         "scheduler step")
    ap.add_argument("--preempt", default=None,
                    choices=("longest_remaining", "lowest_priority"),
                    help="slot preemption policy under queue pressure")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bound the admission queue at N; an overflow is "
                         "shed as queue_full")
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                    help="give every request a MS deadline and shed the "
                         "ones no admission could meet")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the run to PATH")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics snapshot after the run")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of generate() "
                         "(or the stream) to DIR")
    args = ap.parse_args(argv)
    if args.trace:
        obs.enable()

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
                       temperature=args.temperature,
                       kernel_plan=args.kernel_plan,
                       plan_artifact=args.plan_artifact)
    if args.arrival_rate is not None and cfg.family == "encdec":
        ap.error("--arrival-rate mode needs a decoder cache "
                 "(encdec archs are not supported by the scheduler)")
    eng = Engine(cfg, model, scfg, device=dev)
    if eng.artifact_report is not None:
        a = eng.artifact_report
        if "error" in a:
            print(f"[serve] plan artifact UNREADABLE ({a['error']}); "
                  f"tuning locally")
        else:
            print(f"[serve] plan artifact: {a['verified']}/{a['total']} "
                  f"entr(ies) verified, {a['rejected']} rejected"
                  + (f" ({a['reasons']})" if a["rejected"] else "")
                  + (f", {a['missing']} unmeasured upstream"
                     if a["missing"] else ""))
    prof = (obs.profile("serve.generate", logdir=args.profile)
            if args.profile else contextlib.nullcontext())
    if args.arrival_rate is not None:
        with prof:
            results = stream(args, cfg, eng)
        report(args, eng)
        return results
    enc_out = None
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        frames = torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))
        with torch.no_grad():
            enc_out = encdec.encode(eng.cfg, eng.model, frames)
    t0 = time.perf_counter()
    with prof:
        out = eng.generate(prompts, args.new, enc_out=enc_out)
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
    report(args, eng)
    return out


def report(args, eng) -> None:
    """The robustness line (degraded requests, failed warmup buckets,
    quarantined plans; only when any), ``--metrics`` and ``--trace``."""
    from repro_torch.compiler import default_cache
    stats = eng.stats()
    quarantined = default_cache().quarantine_entries()
    if stats["degraded_requests"] or stats["warmup_failed"] or quarantined:
        print(f"[serve] DEGRADED: {stats['degraded_requests']} request(s) "
              f"served off the planned path, {stats['warmup_failed']} "
              f"warmup bucket(s) failed, {len(quarantined)} plan(s) "
              f"quarantined")
        for key, q in sorted(quarantined.items()):
            print(f"[serve]   quarantine {key[:20]}…: {q['reason']} "
                  f"(fail #{q['fails']})")
    if args.metrics:
        for line in obs.format_snapshot(obs.snapshot()).splitlines():
            print(f"[metrics] {line}")
    if args.trace:
        obs.write_trace(args.trace,
                        metadata={"arch": args.arch, "batch": args.batch,
                                  "prompt_len": args.prompt_len,
                                  "n_new": args.new})
        print(f"[serve] trace written to {args.trace} "
              f"(open at https://ui.perfetto.dev)")


def stream(args, cfg, eng):
    """Stream mode: the reference's seeded trace through
    ``Engine.serve_stream``; returns the completed requests."""
    from repro_torch.serve import scheduler as sched_mod
    reqs = sched_mod.synthetic_workload(
        args.requests, seed=1,
        prompt_lens=(max(1, args.prompt_len // 2), args.prompt_len),
        new_tokens=(args.new,), arrival_rate=args.arrival_rate,
        vocab=cfg.vocab_size,
        deadlines_ms=((args.deadline_ms,) if args.deadline_ms is not None
                      else None))
    occ = []
    t0 = time.perf_counter()
    results, shed = eng.serve_stream(
        reqs, max_slots=args.max_slots,
        step_hook=lambda snap: occ.append(snap["occupancy"]),
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        preempt_policy=args.preempt, max_queue=args.max_queue,
        deadline_aware=args.deadline_ms is not None, return_shed=True)
    dt = time.perf_counter() - t0
    total_new = sum(r.n_new for r in reqs)
    served_new = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft_s for r in results) or [float("nan")]
    waits = [r.queue_wait_steps for r in results] or [0]
    print(f"[serve] {cfg.name} on {eng.device} ({route(cfg)}): streamed "
          f"{len(results)}/{len(reqs)} requests ({served_new}/{total_new} "
          f"new tokens) in {dt:.3f}s wall, {served_new / dt:.1f} tok/s at "
          f"rate {args.arrival_rate}")
    print(f"[serve] slots: peak occupancy {max(occ, default=0)}/"
          f"{args.max_slots or args.batch} over {len(occ)} steps; queue "
          f"wait: max {max(waits)} step(s); ttft (from submit) p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f}ms")
    n_pre = sum(r.preemptions for r in results)
    if n_pre:
        print(f"[serve] preemptions: {n_pre} across "
              f"{sum(1 for r in results if r.preemptions)} request(s) "
              f"(policy {args.preempt})")
    if shed:
        reasons: dict = {}
        for r in shed:
            reasons[r.reason] = reasons.get(r.reason, 0) + 1
        detail = ", ".join(f"{k}={v}" for k, v in sorted(reasons.items()))
        print(f"[serve] SHED: {len(shed)}/{len(reqs)} request(s) rejected "
              f"by admission control ({detail})")
    if results:
        first = min(results, key=lambda r: r.rid)
        print("[serve] first request tokens:",
              [int(t) for t in first.tokens[:16]])
    return results


if __name__ == "__main__":
    main()
