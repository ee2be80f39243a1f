"""Where serving time goes on the card: ``torch.profiler`` over one prefill
and a few steady decode steps of ``Engine.generate``'s path.

    PYTHONPATH=src python -m repro_torch.launch.profile --attention-impl pallas
    PYTHONPATH=src python -m repro_torch.launch.profile --arch mamba2-1.3b \
        --ssm-impl pallas
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch deepseek-v2-lite-16b --moe-ragged
    PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch whisper-base \
        --prompt-len 384

Serves ``--arch`` (qwen3-0.6b by default) at full width (seeded bf16
weights, as ``chip_smoke.py``) once to warm up, then profiles a
fresh-cache prefill and ``--steps`` decode steps (``profile_serving``
does the same for a config it is given, such as ``chip_smoke.py``'s
deepseek-v3 at a cut depth).  ``--attention-impl`` and ``--ssm-impl``
(both ``pallas`` by default) apply to the layers that have them, both to
a hybrid config.  An enc-dec config (whisper-base) gets seeded frames
(batch, encoder_seq, d_model) and a third phase, the encoder, whose
output every prefill and decode step attends over.  Per phase it prints
the host wall time, the device's busy
time (the sum of kernel and copy times on the card; the port runs one
stream), the idle share, the kernel count and the kernels that take most
device time.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import load_arch
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import Engine, ServeConfig


def _report(name: str, prof, wall_s: float, steps: int,
            top: int) -> Optional[dict]:
    """Prints one phase and returns it: wall and busy ms/step, the idle
    share, and per kernel name its ms/step and launches/step (None where
    the profiler recorded no device time)."""
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"[profile] {name}: the profiler recorded no device events; "
              f"device time not measured")
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    wall_us = wall_s * 1e6
    idle = max(0.0, 1 - busy_us / wall_us)
    print(f"[profile] {name}: wall {wall_us / steps / 1e3:.3f} ms/step, "
          f"device busy {busy_us / steps / 1e3:.3f} ms/step, idle "
          f"{idle:.1%}, {len(events) / steps:.0f} "
          f"device kernels/step over {steps} step(s)")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for kname, (us, n) in ranked[:top]:
        print(f"[profile]   {us / busy_us:6.1%} {us / steps / 1e3:8.4f} "
              f"ms/step  x{n / steps:5.1f}/step  {kname[:90]}")
    return {"wall_ms": wall_us / steps / 1e3, "busy_ms": busy_us / steps / 1e3,
            "idle": idle,
            "kernels": {k: (us / steps / 1e3, n / steps)
                        for k, (us, n) in ranked}}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Optional[dict]]:
    """Profiles one prefill and ``--steps`` decode steps of ``--arch``;
    returns each phase's ``_report``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--attention-impl", default="pallas",
                    choices=("xla_chunked", "pallas"))
    ap.add_argument("--ssm-impl", default="pallas", choices=("xla", "pallas"))
    ap.add_argument("--moe-ragged", action="store_true",
                    help="MoE layers through the ragged grouped-GEMM kernel")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(load_arch(args.arch),
                              attention_impl=args.attention_impl,
                              ssm_impl=args.ssm_impl)
    if args.moe_ragged:
        cfg = serve.moe_ragged(cfg)
    return profile_serving(cfg, batch=args.batch, prompt_len=args.prompt_len,
                           steps=args.steps, top=args.top)


def profile_serving(cfg, *, batch: int = 8, prompt_len: int = 512,
                    steps: int = 8, top: int = 8, model=None
                    ) -> Dict[str, Optional[dict]]:
    """Profiles one prefill and ``steps`` decode steps of ``cfg`` served by
    ``Engine`` on the card (and an enc-dec model's encoder), on ``model``
    or on seeded bf16 weights; returns each phase's ``_report``."""
    if model is None:
        model = convert.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
            torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    eng = Engine(cfg, model, ServeConfig(batch=batch,
                                         max_len=prompt_len + steps + 2))
    frames = enc_out = None
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        frames = torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(2))

        def encode():
            with torch.no_grad():
                return encdec.encode(eng.cfg, eng.model, frames)
        enc_out = encode()
    # warm: builds, cuBLAS, allocator
    toks = eng.generate(prompts, 2, enc_out=enc_out)
    impl = serve.route(cfg)
    print(f"[profile] {cfg.name} ({cfg.n_layers} layers) {impl}, batch "
          f"{batch}, prompt {prompt_len}, on "
          f"{torch.cuda.get_device_name(0)}")

    def run_encode(_cache):
        encode()
        torch.cuda.synchronize()

    def run_prefill(_cache):
        eng.prefill(prompts, enc_out)         # ends in a synchronize

    def run_decode(cache):
        cur = toks[:, :1]
        batch = {} if enc_out is None else {"enc_out": enc_out}
        with torch.no_grad():
            for _ in range(steps):
                logits, cache = model_mod.decode_step(
                    eng.cfg, eng.model, dict(batch, tokens=cur), cache)
                cur = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()

    runs = [("prefill", run_prefill, 1), ("decode", run_decode, steps)]
    if frames is not None:
        runs.insert(0, ("encode", run_encode, 1))
    phases = {}
    for name, run, n in runs:
        # the wall time comes from an unprofiled run: the profiler adds
        # host work; the device time from a profiled run of the same steps
        fresh = (lambda: eng.prefill(prompts, enc_out)[0]) \
            if name == "decode" else (lambda: None)
        cache = fresh()
        t0 = time.perf_counter()
        run(cache)
        wall = time.perf_counter() - t0
        cache = fresh()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(cache)
        phases[name] = _report(name, prof, wall, n, top)
    return phases


if __name__ == "__main__":
    main()
