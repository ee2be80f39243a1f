#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions; TF32 off for matmuls and cuDNN.
2. build: nvcc builds every kernel of ``src/repro_torch/csrc`` in parallel.
3. each kernel against its plain PyTorch version on the same inputs:
   (a) fp32 at small ragged GQA shapes, atol 1e-5;
   (b) the serving shapes and dtypes of the main path, atol 2e-2 on the
       bf16 outputs; then kernel, plain and SDPA times beside the bound.
4. end to end: qwen3-0.6b at full width (seeded random bf16 weights),
   batch 8, prompt 512, 64 new tokens through ``Engine.generate`` with
   ``attention_impl='pallas'``; launch counts are read around that run.
   The same weights and tokens then go through the plain route
   (``attention_impl='xla_chunked'``) and each step's logits are held to
   the kernel route's.
5. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports torch and the port only; nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
PEAK_BF16 = 989e12            # dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12             # fp32 outside the tensor cores
ATOL_FP32 = 1e-5              # kernel vs plain, fp32 inputs
ATOL_BF16 = 2e-2              # kernel vs plain, bf16 outputs (2^-8 rounding)
# kernel route vs plain route logits after 28 bf16 layers: the two differ
# only in fp32 summation order inside attention, which flips single bf16
# roundings of attention outputs; logits of these random weights are
# about 3 at most, so 0.1 bounds a 3% drift
ATOL_E2E_LOGITS = 0.1
TIMING_ITERS = 20


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound(nbytes: float, flops: float, peak: float):
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Per-launch CUDA-event times, with L2 (50 MB) flushed before each."""

    def __init__(self):
        self._flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                  device="cuda")

    def ms(self, fn, iters: int = TIMING_ITERS) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def host_us(fn, iters: int = 200) -> float:
    """Host time (µs) to issue one call, the card's work excluded: what a
    host-bound decode step pays per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def warm_ttft_ms(eng, prompts, reps: int = 3) -> float:
    """Median time (ms) of prefill + first argmax, after the first call."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eng.prefill(prompts)[1].argmax(-1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {nvcc[-1]}")
    print(f"[env] device: {torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}, count "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    wall = time.perf_counter() - t0
    for name, rep in report.items():
        print(f"[build] {name}.cu: {rep['seconds']:.2f}s")
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels built in {wall:.2f}s (parallel nvcc)")


def phase_kernels(timer: Timer):
    """Each kernel against its plain version; returns the kernels entries."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1234)

    # (a) fp32, small ragged shapes: GQA, S / T not tile multiples, S != T
    for b, h, hkv, s, t, d, causal in [
            (2, 4, 2, 37, 37, 64, True), (2, 4, 2, 37, 37, 64, False),
            (1, 4, 4, 100, 130, 32, False), (1, 6, 2, 130, 130, 128, True),
            (2, 4, 1, 70, 37, 32, True), (1, 2, 2, 5, 200, 128, False)]:
        q, k, v = (randn(gen, b, h, s, d), randn(gen, b, hkv, t, d),
                   randn(gen, b, hkv, t, d))
        e = err(fa.flash_attention_cuda(q, k, v, causal=causal),
                ref.flash_attention(q, k, v, causal=causal))
        print(f"[flash fp32] B{b} H{h}/{hkv} S{s} T{t} D{d} causal={causal}: "
              f"max abs err {e:.3g}")
        check(e <= ATOL_FP32, f"flash fp32 err {e} > {ATOL_FP32}")
    for b, h, hkv, t, d, pos in [(4, 8, 2, 37, 64, [0, 36, 17, 5]),
                                 (3, 4, 4, 200, 128, [199, 0, 64]),
                                 (2, 16, 8, 577, 128, [576, 511])]:
        q, k, v = (randn(gen, b, h, d), randn(gen, b, hkv, t, d),
                   randn(gen, b, hkv, t, d))
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        e = err(da.decode_attention_cuda(q, k, v, p),
                ref.decode_attention(q, k, v, p))
        print(f"[decode fp32] B{b} H{h}/{hkv} T{t} D{d} pos={pos}: "
              f"max abs err {e:.3g}")
        check(e <= ATOL_FP32, f"decode fp32 err {e} > {ATOL_FP32}")

    # (b) main-path shapes and dtypes
    b, h, hkv, s, d = 8, 16, 8, 512, 128
    q = randn(gen, b, h, s, d, dtype=torch.bfloat16)
    k = randn(gen, b, hkv, s, d, dtype=torch.bfloat16)
    v = randn(gen, b, hkv, s, d, dtype=torch.bfloat16)
    e_fa = err(fa.flash_attention_cuda(q, k, v, causal=True),
               ref.flash_attention(q, k, v, causal=True))
    print(f"[flash bf16] B{b} H{h}/{hkv} S=T={s} D{d} causal: max abs err "
          f"{e_fa:.3g} (atol {ATOL_BF16})")
    check(e_fa <= ATOL_BF16, f"flash bf16 err {e_fa} > {ATOL_BF16}")
    pairs = sum(min(i + 1, s) for i in range(s))
    fa_bound, fa_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                            4.0 * b * h * d * pairs, PEAK_BF16)
    fa_ms = timer.ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    fa_plain = timer.ms(lambda: ref.flash_attention(q, k, v, causal=True))
    fa_lib = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    print(f"[flash bf16] kernel {fa_ms:.4f} ms, plain {fa_plain:.4f} ms, "
          f"SDPA {fa_lib:.4f} ms, bound {fa_bound:.4f} ms ({fa_by})")

    t, pos_main = 577, 575   # max_len of the e2e run; its deepest step
    qd = randn(gen, b, h, d, dtype=torch.bfloat16)
    kc, vc = randn(gen, b, hkv, t, d), randn(gen, b, hkv, t, d)
    pd = torch.full((b,), pos_main, dtype=torch.int32, device="cuda")
    e_da = err(da.decode_attention_cuda(qd, kc, vc, pd),
               ref.decode_attention(qd, kc, vc, pd))
    print(f"[decode bf16] B{b} H{h}/{hkv} T{t} D{d} q bf16, cache fp32, "
          f"pos {pos_main}: max abs err {e_da:.3g} (atol {ATOL_BF16})")
    check(e_da <= ATOL_BF16, f"decode err {e_da} > {ATOL_BF16}")
    n_keys = b * (pos_main + 1)
    da_bound, da_by = bound(
        2 * qd.numel() * 2 + pd.numel() * 4 + 2 * n_keys * hkv * d * 4,
        4.0 * h * d * n_keys, PEAK_FP32)
    da_ms = timer.ms(lambda: da.decode_attention_cuda(qd, kc, vc, pd))
    da_plain = timer.ms(lambda: ref.decode_attention(qd, kc, vc, pd))
    q4 = qd.float()[:, :, None, :]
    keep = (torch.arange(t, device="cuda")[None, :] <= pd[:, None])
    keep = keep[:, None, None, :]
    da_lib = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=keep, enable_gqa=True))
    print(f"[decode] kernel {da_ms:.4f} ms, plain {da_plain:.4f} ms, "
          f"SDPA {da_lib:.4f} ms, bound {da_bound:.4f} ms ({da_by})")
    print(f"[decode] host time per call: kernel wrapper "
          f"{host_us(lambda: da.decode_attention_cuda(qd, kc, vc, 575)):.1f} "
          f"µs, plain {host_us(lambda: ref.decode_attention(qd, kc, vc, 575)):.1f}"
          f" µs")

    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:103",
         "max_abs_err": e_fa, "ms": fa_ms, "plain_ms": fa_plain,
         "bound_ms": fa_bound, "bound_by": fa_by, "library_ms": fa_lib},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/compiler/pallas_backend.py:784",
         "max_abs_err": e_da, "ms": da_ms, "plain_ms": da_plain,
         "bound_ms": da_bound, "bound_by": da_by, "library_ms": da_lib},
    ]


def phase_e2e():
    """Full-width qwen3-0.6b through Engine.generate; returns launches."""
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import convert
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import Engine, ServeConfig

    batch, prompt_len, n_new = 8, 512, 64
    cfg = dataclasses.replace(CONFIG, attention_impl="pallas")
    t0 = time.perf_counter()
    model = convert.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[e2e] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim_}, vocab "
          f"{cfg.vocab_size}; seeded bf16 weights in "
          f"{time.perf_counter() - t0:.2f}s")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    scfg = ServeConfig(batch=batch, max_len=prompt_len + n_new + 1)
    eng = Engine(cfg, model, scfg)

    fa.launches = da.launches = 0
    toks, logits = eng.generate(prompts, n_new, return_logits=True)
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    print(f"[e2e] launches: {launches}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash launches {launches['flash_attention']} != {cfg.n_layers}")
    check(launches["decode_attention"] == cfg.n_layers * n_new,
          f"decode launches {launches['decode_attention']} != "
          f"{cfg.n_layers * n_new}")
    check(tuple(toks.shape) == (batch, n_new), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token ids out of range")
    check(tuple(logits.shape) == (n_new, batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "logits not finite")

    st = eng.stats()
    dec = st["phases"]["decode"]
    steady = dec["steady_mean_s"]
    print(f"[e2e] pallas route: TTFT {st['ttft_s'] * 1e3:.2f} ms (first "
          f"prefill of the process), warm TTFT "
          f"{warm_ttft_ms(eng, prompts):.2f} ms; decode "
          f"{steady * 1e3:.3f} ms/step mean, "
          f"{dec['steady_p50_s'] * 1e3:.3f} ms p50 over {dec['steps']} "
          f"steps; {batch / steady:.1f} tokens/s")

    # plain route, same weights: timed through the same Engine.generate,
    # then the kernel route's tokens fed to it for the logits comparison
    cfg_plain = dataclasses.replace(eng.cfg, attention_impl="xla_chunked")
    plain = Engine(cfg_plain, model, scfg)
    plain.generate(prompts, n_new)
    pdec = plain.stats()["phases"]["decode"]
    print(f"[e2e] plain route: warm TTFT {warm_ttft_ms(plain, prompts):.2f} "
          f"ms; decode {pdec['steady_mean_s'] * 1e3:.3f} ms/step mean, "
          f"{pdec['steady_p50_s'] * 1e3:.3f} ms p50 over {pdec['steps']} "
          f"steps")
    cache, last = plain.prefill(prompts)
    diffs = [err(last, logits[0])]
    agree = [(last.argmax(-1) == logits[0].argmax(-1)).float().mean().item()]
    with torch.no_grad():
        for i in range(n_new - 1):
            lg, cache = model_mod.decode_step(
                cfg_plain, model, {"tokens": toks[:, i:i + 1]}, cache)
            lg = lg[:, -1]
            diffs.append(err(lg, logits[i + 1]))
            agree.append((lg.argmax(-1) == logits[i + 1].argmax(-1))
                         .float().mean().item())
    print(f"[e2e] kernel vs plain route logits: prefill max abs diff "
          f"{diffs[0]:.4g}, decode steps max {max(diffs[1:]):.4g} (atol "
          f"{ATOL_E2E_LOGITS}; max |logit| {logits.abs().max().item():.3g}); "
          f"greedy argmax agreement {statistics.fmean(agree):.4f}")
    check(max(diffs) <= ATOL_E2E_LOGITS,
          f"route logits differ by {max(diffs)} > {ATOL_E2E_LOGITS}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA Hopper card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    phase_env()
    phase_build()
    timer = Timer()
    kernels = phase_kernels(timer)
    launches = phase_e2e()
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
