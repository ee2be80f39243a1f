#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions; TF32 off for matmuls and cuDNN.
2. build: nvcc builds every kernel of ``src/repro_torch/csrc`` in parallel.
3. each kernel against its plain PyTorch version on the same inputs:
   (a) flash and (b) decode attention: fp32 at small ragged GQA shapes,
       every pump case each kernel is built for (T1 / T2 / T4 / R2 / R4,
       ``built``) within atol 1e-5 of the plain version (flash's final m
       and l too) and with T1's bits; flash also in bf16 (its tensor-core
       body) at small ragged GQA shapes, D 16 to 128, atol 2e-2 on o and
       ``RTOL_FLASH_STATS_BF16`` on m and l, every case with T1's bits;
       then the serving shapes and dtypes of the qwen3 path in every
       built case, atol 2e-2 on the bf16 outputs, with kernel (per pump
       case), plain and SDPA times beside the bound, flash's TFLOP/s and
       its factor to SDPA, and flash T1 also timed with no hold before the
       start event (``Timer.late`` counts the samples that held host time);
       decode attention's ``splits`` (the wrapper's and the built
       kernel's must agree), each pump case over T1, and T1 at pos 63, 319
       and 575, each within atol 2e-2; decode attention at per-row
       positions as a stream's per-slot decode gives them
       (``STREAM_ROW_POS`` at B 8, T 577, row 7 a free lane past the end)
       in every built pump case within atol 2e-2 and with T1's bits, and in
       fp32 at a small ragged shape within atol 1e-5;
   (c) the SSD scan and (d) the SSD decode step: fp32 at small ragged
       shapes through strided views (the scan in every built pump case,
       with T1's bits), then the mamba2-1.3b path's shapes and dtypes,
       each under the relative tolerance stated at its constant, with
       kernel (the scan's per pump case) and plain times beside the
       bound;
   (e) vecadd, (f) matmul, (g) the stencil stage and (h) Floyd-Warshall:
       small ragged shapes in every pump case (vecadd, integer-valued
       matmul, the stencil (M 1 / 2 / 4 / 8) and Floyd-Warshall exact),
       then the paper tables' card sizes (matmul under
       ``launch.paper.RTOL_MATMUL``, Table 3's three cases with
       mmm_32PE_O's bits; a jacobi and a diffusion stencil stage at M 1, 2
       and 4 with the plain version's bits, each timed, one launch a
       stage, beside a copy of the volume) with kernel, plain, library and
       bound times.  Vecadd's every Table 2 row timed beside ``torch.add``.
       Floyd-Warshall bit-exact (NaN at
       the same places) also on ``fw_graph``'s inputs with
       ``inf``, negative weights on a DAG and NaN at n 100 and 500, at n
       that its 64-pivot rounds do not divide, and at n 4096 in every
       pump case, each timed; every call moves ``launches`` by
       ``launches_per_call``;
   (i) the grouped GEMM: small ragged groups (empty experts, one-row
       groups), the dense form with ragged C, F and D, and a worst-case
       device table, in every built tile (bf16 on the tensor cores) and
       pump case (exact on integer values, 1e-5 of the largest value on
       normal ones); then deepseek-v2-lite's MoE shapes in bf16 (the
       padded groups of a seeded top-6 routing of a prefill of 8 x 512
       tokens in 128-row tiles and of one decode step of 8 in 16-row
       tiles) under ``RTOL_GG_BF16``, with kernel, plain, library and
       bound times;
   (j) the compiler, ``repro_torch.compiler.compile``: (a) the nine IR
       builders (and a second ragged grouped GEMM with an empty expert) at
       small integer-valued shapes, M 1 / 2 / 4 x T / R, through the
       ``hopper`` and ``torch`` backends on CUDA tensors against the port's
       numpy executor (exact, or ``ATOL_EXP`` where exp enters), each
       region at its expected tier (the carry builders' at ``hopper``
       wherever their kernel is built for the case); (b) the region kernel
       (``csrc/region_map_reduce.cu``) against its plain version on small
       ragged descriptors, add and dot, fp32 and bf16 (the bf16 dots of
       whole 16-row tiles on the tensor cores), M 1-8 x T / R;
       (c) vecadd 2^28, matmul 4096^3, the ragged grouped GEMM at the
       deepseek prefill's routing and mamba2's SSD decode step compiled to
       the ``hopper`` tier and run once (the launches of that run are
       counted), held to the direct kernels and the plain versions, with
       region-kernel, direct, plain, library and bound times;
       (d) ``autotune='measure'`` on the four, then a fresh-memo compile
       that replays the measured factor from the cache with zero
       measurements; ``pump='measure'`` on flash, decode attention and
       the SSD scan, whose kernels' launch counts must move.
   (k) the shapes the newer configs' serving paths give the kernels, each
       in every built pump case against its plain version under the
       tolerance of (b), (c) or (d), timed beside its bound and SDPA:
       flash (B 8, S 512, bf16, causal) and decode attention (B 8, T 577,
       fp32 cache) at qwen2-7b's, qwen2.5-14b's, granite-3-2b's and
       zamba2-2.7b's heads (groups of 7, 5, 4 and 1; D 128, 128, 64, 80);
       the SSD scan and decode step at zamba2's widths (H 80, N 64).  The
       grouped GEMM's (i) also runs deepseek-v3's MoE shapes (256 experts
       top-8, 7168 <-> 2048, prefill and decode routings).
   (m) the shapes whisper-base's and internvl2-2b's paths give the
       attention kernels, the same way: flash non-causal at the encoder's
       B 8, 8 / 8 heads, S = T = 1500 (a last key tile of 28), D 64; flash
       causal at whisper's prefill (S 384, D 64) and internvl2's
       image-prefixed forward (16 / 8 heads, S 768, D 128); decode
       attention at whisper's decode (group 1, T 448, D 64, fp32 cache) at
       pos 384 and at per-row positions ``WHISPER_ROW_POS``.
4. end to end, qwen3-0.6b at full width (seeded random bf16 weights),
   batch 8, prompt 512, 64 new tokens through ``Engine.generate`` with
   ``attention_impl='pallas'``; launch counts are read around that run.
   The same weights and tokens then go through the plain route
   (``attention_impl='xla_chunked'``) and each step's logits are held to
   the kernel route's.  Then the same weights and prompts through the
   plan registry (``kernel_plan='measure'``, its own compile cache
   ``REGISTRY_CACHE``): the engine's warmup plans the bucket grid
   (printed; every plan measured, at the ``hopper`` tier and inside its
   kernel's built set), then ``generate`` with 28 flash launches per
   prefill and 28 decode launches per step, no registry miss and no
   fallback after the warmup, TTFT and ms/step beside the direct route's,
   every step's logits within ``ATOL_E2E_LOGITS`` of the direct route's
   and the tokens identical where every plan gives T1's bits (checked at
   the serving shapes), and the host µs of one warm registry call.  Then
   ``launch.profile`` over qwen3's decode steps: the decode kernel's
   device time per call beside the step's busy and wall time.  Then
   qwen3's **stream** (continuous batching, ``Engine.serve_stream``) on the
   same weights, ``ServeConfig(batch=8, max_len=577)``, direct route: a
   seeded FIFO trace of 16 requests (prompts 128 / 256 / 512, 16 or 32 new
   tokens, 0.5 arrivals a step) with its launches counted (28 flash per
   admission group, counted from the step snapshots as distinct prompt
   lengths per admitting step; 28 decode attentions per decode step, at a
   (B,) device pos), each request held to its run alone through
   ``generate`` (``ATOL_E2E_LOGITS`` up to the first differing token,
   which may differ only at a top-2 gap under it), tokens/s against the
   solo runs' summed wall (at least 1.3x, the reference harness's bar),
   occupancy, steps, ms a step and TTFT p50; the same trace with
   ``prefill_chunk_tokens=256`` (the 512-token prompts in two continuation
   chunks) and with seeded priorities, ``lowest_priority`` preemption and
   4 slots (at least one preemption, every request done), both held to the
   FIFO stream's logits the same way.
5. end to end, mamba2-1.3b at full width the same way, with
   ``ssm_impl='pallas'`` against ``ssm_impl='xla'``, and through the plan
   registry the same way (48 scans per prefill, 48 SSD decode steps per
   step, ``ATOL_E2E_SSM_LOGITS``), then its stream: 8 requests (prompts
   256 / 512) with ``prefill_chunk_tokens=256``, 48 scans per admission
   group and per continuation chunk, 48 SSD decode steps per step, held to
   each request alone under ``ATOL_E2E_SSM_LOGITS``; a fresh registry after
   ``compiler.clear_memo()`` on the same cache then warms both models'
   grids with zero measurements; then
   deepseek-v2-lite-16b at full width (27 layers, 64 experts, 31.4 GB of
   bf16 weights) the same way, its MoE layers dropless through the ragged
   grouped GEMM (78 launches per prefill and per decode step) against the
   dense dropless einsum path: one MoE layer on the same input under
   ``RTOL_MOE_LAYER``, then every step's logits under
   ``ATOL_E2E_MOE_LOGITS``, with the peak device memory; then that MoE
   layer through the plan registry's ragged route (the compiled ragged
   graph on the region kernel at pump 1, plans never measured) against
   the direct ``csrc/grouped_gemm.cu`` route under ``RTOL_MOE_LAYER``,
   both timed warm, with the registry route's cold first call of a new
   routing and the gate product at the capacity model's pump.  zamba2-2.7b
   (the hybrid family, 54 Mamba-2 blocks and one shared attention block
   after every 6) comes before the replay, the same way with both impls
   at ``'pallas'`` against ``'xla_chunked'`` / ``'xla'`` (54 scans and 9
   flash launches per prefill, 54 SSD decode steps and 9 decode
   attentions per step, ``ATOL_E2E_HYBRID_LOGITS``), through the plan
   registry too, whose warmup plans all four serving kernels; the replay
   covers the three models' grids.  After deepseek-v2-lite:
   qwen2.5-14b at full width (48 layers, 40/8 heads x 128, ``qkv_bias``;
   48 flash launches per prefill, 48 decode attentions per step,
   ``ATOL_E2E_QWEN25_LOGITS``); whisper-base at full width (the enc-dec
   family: seeded frames (8, 1500, 512) for the stub frontend through
   ``encdec.encode`` on both routes, 6 non-causal flash launches on the
   kernel route; ``Engine(batch 8, max_len 448)`` generating 64 tokens
   after a 384-token prompt on each route's own encoder output, 6 flash
   launches a prefill and 6 decode attentions a step,
   ``ATOL_E2E_WHISPER_LOGITS`` at every step, the encoder's ms, and
   ``launch.profile``'s encoder, prefill and decode rows); internvl2-2b
   at full width as qwen3 (24 flash launches a prefill, 24 decode
   attentions a step, ``ATOL_E2E_INTERNVL2_LOGITS``), then its
   image-prefixed ``model.forward`` (patches (8, 256, 1024), 512 tokens,
   ``last_only``; 24 flash launches, last-position logits within the
   same tolerance of the plain route's); and deepseek-v3-671b at full width and
   ``DSV3_LAYERS`` deep (3 dense and 2 MoE layers; 6 grouped-GEMM launches
   per prefill and per step), whose plain route, MoE layer check and
   logits comparison run at 8 x ``DSV3_HOLD_PROMPT`` prompt tokens (the
   reason at the constant).  zamba2, qwen2.5-14b, whisper-base,
   internvl2-2b and deepseek-v3 are profiled by ``launch.profile`` (device busy and idle per prefill and
   decode step) on the kernel route's weights.
6. the paper-table path: ``repro_torch.launch.paper --mode all`` at the
   card sizes, in this process, every row held to its plain version;
   launch counts of the four paper kernels are read around that run.
7. a ``{"robustness": {...}}`` line (phase 8's counters and launches, and
   each serving phase's guard deltas), a ``{"kernels": [...]}`` line
   (each kernel's launches summed over the paths, and per path under
   ``launches_by_path``; the streams of qwen3 and mamba2 are the
   ``stream`` path, whisper-base's counts its encoder, prefill and steps,
   internvl2-2b's its generate and image-prefixed forward, phase 8's is
   ``robustness``), then the last line ``{"ok": true, "device":
   {...}}``.  Each phase prints its seconds.
8. robustness, after mamba2's path and before zamba2's, on the qwen3 and
   mamba2 weights already on the card (``phase_robustness``): qwen3's
   ``generate`` traced (``repro_torch.obs``; the Chrome trace written to
   ``build/robustness_trace.json``, its ``serve.*`` spans, histograms and
   launches checked); the decode step's instrumentation cost (the raw
   ``model.decode_step`` loop against ``Engine.decode_token`` with tracing
   off and on, interleaved step by step, 3 x 64 steps each; off at most
   1.05x the raw loop);
   a decode fault at step 11 re-run on the plain route; NaN injected into
   mamba2's SSD decode plans at two steps, caught by the NaN guard and
   re-run; qwen3's registry warmed under a measurement timeout and a
   garbage cache file.  Every serving phase (qwen3, mamba2, zamba2, the
   registry and its replay, deepseek-v2-lite, qwen2.5-14b, whisper-base,
   internvl2-2b, deepseek-v3 cut, both streams) runs inside ``guarded``:
   its ``engine.degraded``, ``degrade.compile`` and
   ``registry.spotcheck_failed`` deltas must be 0, so no rung of the
   degradation ladder quietly stands in for a kernel on the card.

Imports torch and the port only; nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ATOL_FP32 = 1e-5              # kernel vs plain, fp32 inputs
ATOL_BF16 = 2e-2              # kernel vs plain, bf16 outputs (2^-8 rounding)
# flash's fp32 m and l from bf16 inputs, relative to the largest |value|:
# the kernel sums q k^T on the tensor cores in fp32 (exact bf16 products,
# another order) and scales after, the plain version scales q first; l
# sums exp2 of the fp32 scores where the plain version sums exp.  That is
# a few fp32 roundings on sums of at most 200 terms (about 1e-6), so 1e-4
# leaves room, while a wrong mask or a lost key tile moves m or l by O(1)
RTOL_FLASH_STATS_BF16 = 1e-4
# kernel route vs plain route logits after 28 bf16 layers: the two differ
# only in fp32 summation order inside attention, which flips single bf16
# roundings of attention outputs; logits of these random weights are
# about 3 at most, so 0.1 bounds a 3% drift
ATOL_E2E_LOGITS = 0.1
# SSD kernels vs their plain versions, relative to the largest |value| of
# the plain output: in fp32 the two sum the same products in another order
# (1e-5 leaves some 50x over fp32's 2^-24 per add for sums of up to 128
# terms); the scan's bf16 y may differ by two bf16 ulps (2^-7) wherever the
# fp32 values straddle a rounding boundary
RTOL_SSD_FP32 = 1e-5
RTOL_SSD_BF16 = 2.0 ** -7
# mamba2 kernel route vs plain route logits after 48 bf16 layers: the plain
# route (a mirror of the reference's _ssd_xla) rounds G, w, the chunk start
# states and exp(logP) to bf16 before its products, the kernel keeps them
# fp32, so each layer's y differs by bf16 rounding (about 2^-9 relative).
# With those operands left fp32 the two routes agree exactly, so this
# rounding is the whole difference; it adds up across layers like a random
# walk, to some 5% of logits that reach about 5 here, and 0.5 (10%) leaves
# room for it while a wrong decay or a lost chunk moves logits by O(1)
ATOL_E2E_SSM_LOGITS = 0.5
# grouped GEMM kernel vs plain on the MoE path's bf16 shapes, relative to
# the largest |value|: both sum D in fp32 (in another order) and round once
# to bf16, so an output may differ by one bf16 ulp, 2^-8 of its binade and
# so at most 2^-7 of the largest value
RTOL_GG_BF16 = 2.0 ** -7
# one MoE layer, ragged kernel route vs dense dropless plain route, on the
# same input, relative to the largest |value|: the routing is identical, the
# expert products sum in another order (kernel fp32 FMAs vs cuBLAS), so h
# and y each round to bf16 with up to one ulp (2^-8 relative) of
# difference, and h's differences carry through the down product: 2^-6
# leaves twice that room, while a wrong expert or row moves y by O(1)
RTOL_MOE_LAYER = 2.0 ** -6
# deepseek-v2-lite kernel route vs plain route logits after 27 bf16 layers:
# on top of the bf16 rounding above, one ulp in a hidden state flips a
# token's top-6 choice wherever two router probabilities nearly tie, and a
# flipped expert moves that token's hidden state by a share of the routed
# output; those flips are real differences between two correct routes, so
# the logits (about 5 at most here) get 2.0, while a wrong kernel makes
# every step's logits unrelated (a diff of the logits' own size).  The
# greedy argmax agreement is printed, not held: over 102,400 random-weight
# logits the top two lie close, and even the qwen3 and mamba2 routes, with
# no routing to flip, agree on only 94-97% of the rows
ATOL_E2E_MOE_LOGITS = 2.0
# zamba2-2.7b kernel route vs plain route logits after 54 Mamba-2 blocks
# and 9 applications of the shared attention block, bf16: each block
# differs as mamba2's do (the plain SSD route rounds G, w, the chunk start
# states and exp(logP) to bf16, about 2^-9 of y) and each shared block as
# qwen3's do (fp32 summation order in attention flips single bf16
# roundings); the differences add up like a random walk over the 63
# mixers, as over mamba2's 48, and the logits reach about 5.5 here, so the
# same 0.5 (9%) leaves room for the drift while a wrong decay, a lost
# chunk or a lost key tile moves the logits by O(1)
ATOL_E2E_HYBRID_LOGITS = 0.5
# qwen2.5-14b kernel route vs plain route logits after 48 bf16 layers: the
# difference is qwen3's (fp32 summation order inside attention flips single
# bf16 roundings of its outputs), a random walk over 48 layers where
# qwen3 has 28 (sqrt(48 / 28) = 1.3 times the drift), on logits that reach
# about 5.6 where qwen3's reach 3; qwen3's 0.1 (3% of its largest logit)
# scaled by both gives 0.25, and 0.3 (5% of the largest logit) leaves room
# for it, while a wrong kernel makes the logits unrelated (a difference of
# their own size)
ATOL_E2E_QWEN25_LOGITS = 0.3
# whisper-base kernel route vs plain route logits after 6 encoder and 6
# decoder bf16 layers, each route on its own encoder output: as in qwen3,
# fp32 summation order inside attention (the encoder's non-causal flash
# over 1500 keys, the decoder's flash and decode attention) flips single
# bf16 roundings, which compound through the encoder (its outputs differ
# by 1.6% of their largest value, about 5) and reach the decoder through
# cross-attention.  On an H100 80GB HBM3 (700 W) the routes differ by
# 0.0187 on logits that reach 2.2; 0.05 (2.3% of the largest logit) leaves 2.7x room, while a
# wrong kernel (a lost key tile, a wrong mask) moves the logits by their
# own size
ATOL_E2E_WHISPER_LOGITS = 0.05
# internvl2-2b kernel route vs plain route logits after 24 bf16 layers
# (16 / 8 heads x 128): qwen3's difference (fp32 summation order inside
# attention flips single bf16 roundings, a random walk over the layers)
# on logits that reach about 5.7 (an untied head) where qwen3's reach
# 3.7; qwen3's 0.1 scaled by that gives 0.15, and 0.2 (3.5% of the
# largest logit) leaves room for it.  On an H100 80GB HBM3 (700 W) the
# routes differ by 0.0983 over the 64 steps and by 0.0678 in the
# image-prefixed forward
ATOL_E2E_INTERNVL2_LOGITS = 0.2
# whisper-base's decoder context, 448 positions (max_target_positions in
# openai/whisper-base's config): a 384-token prompt and 64 new tokens
WHISPER_MAX_LEN = 448
WHISPER_PROMPT = 384
# the per-row positions phase 3 (m) checks whisper's decode attention at
# (B 8, T 448): a lane at 0, lanes on either side of a 64-key tile, the
# prompt's last token and the first decode step's, the last key, and a
# lane past the end of the cache (pos >= T keeps every key)
WHISPER_ROW_POS = [0, 63, 64, 200, 383, 384, 447, 500]
# deepseek-v3-671b on one card: every width, the depth cut to its 3 dense
# layers and 2 MoE layers (27.2 B parameters, 54 GB of bf16 weights; the
# 61 layers are 671 B).  Its plain route, the dense dropless einsum path,
# scatters a prefill's t tokens into (256 experts, 8 t, 7168) buffers, two
# of which live at once (the expert outputs and their padded copy): 2 x
# 15 GB at 8 x 64 tokens, more than the 26 GB left beside the weights, and
# 2 x 7.5 GB at 8 x 32.  So the plain route, the MoE layer check and the
# logits comparison run at 8 x 32 prompt tokens; the kernel route's
# launches and times stay at 8 x 512
DSV3_LAYERS = 5
DSV3_HOLD_PROMPT = 32
# compiled graphs vs the port's numpy executor where exp enters (flash and
# decode attention, the SSD scan and decode step): numpy's and the card's
# exp differ by an ulp on some inputs, amplified by the sums after it; the
# reference's differential harness holds its own backends to the same
# rtol = atol (tests/differential.py); the rest are exact on integer values
ATOL_EXP = 5e-6
# the region kernel vs its plain version on normal bf16 values, relative to
# the largest |value|: both sum in fp32 in another order and round once, so
# an output may differ by one bf16 ulp, at most 2^-7 of the largest value
RTOL_REGION_BF16 = 2.0 ** -7
# the per-row decode positions phase 3 (b) checks at T 577: a lane at 0,
# lanes on either side of a 64-key tile, deep ones, the last key, and a
# free lane past the end of the cache (pos >= T keeps every key)
STREAM_ROW_POS = [0, 63, 64, 200, 319, 575, 576, 600]
# the per-row positions phase 3 (l) checks at B 4, T 577, as the preempted
# stream's four lanes give them: a lane just past a 128-token prompt, two
# deeper ones (543, the deepest a request reaches: 512 + 32 - 1) and a
# free lane past the end of the cache
STREAM_B4_POS = [128, 300, 543, 640]
# the pump cases the kernels of rows 1, 2, 8 and 10 are swept over
PUMP_CASES = ((1, "T"), (2, "T"), (4, "T"), (2, "R"), (4, "R"))
# where chip_smoke keeps the compile cache of its autotune phase
BUILD_CACHE = Path(__file__).resolve().parent / "build" / "chip_smoke"
# the plan registry phase's own compile cache, emptied at its start so its
# warmup measures every plan and the replay reads only what it wrote
REGISTRY_CACHE = BUILD_CACHE / "registry_cache.json"


@contextlib.contextmanager
def timed(phase: str):
    """Prints the seconds a phase of this run took."""
    t0 = time.perf_counter()
    yield
    print(f"[time] {phase}: {time.perf_counter() - t0:.1f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return (a.float() - b.float()).abs().max().item()


FW_KINDS = ("uniform", "missing", "negative_dag", "nan")


def fw_graph(n: int, kind: str, seed: int) -> torch.Tensor:
    """A seeded (n, n) fp32 distance matrix on the CPU, with a zero
    diagonal, on which Floyd-Warshall's exactness is checked: ``uniform``
    (0.1, 10) weights as Table 6 draws them; ``missing``, the same with 30%
    of the edges ``inf``; ``negative_dag``, weights in (-5, 10) on the
    edges of a DAG (each node reaches only those after it in a seeded
    order, so no cycle is negative) and ``inf`` elsewhere; ``nan``, the
    uniform weights with a NaN on the diagonal at a seeded node, which the
    min carries to that node's row and column and nowhere else (a NaN off
    the diagonal reaches every pair within two steps: inf + NaN is NaN)."""
    if kind not in FW_KINDS:
        raise ValueError(f"fw_graph: kind {kind!r} not in {FW_KINDS}")
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.1, 10.0, (n, n)).astype(np.float32)
    if kind == "missing":
        d[rng.random((n, n)) < 0.3] = np.inf
    elif kind == "negative_dag":
        order = rng.permutation(n)
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n)
        w = rng.uniform(-5.0, 10.0, (n, n)).astype(np.float32)
        d = np.where(rank[:, None] < rank[None, :], w, np.float32(np.inf))
    np.fill_diagonal(d, 0.0)
    if kind == "nan":
        p = rng.integers(n)
        d[p, p] = np.nan
    return torch.from_numpy(np.ascontiguousarray(d, np.float32))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN at the same places and the same bits everywhere else (NaN
    payloads are not compared)."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{tuple(a.shape)} {a.dtype} != {tuple(b.shape)} {b.dtype}")
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|)."""
    return err(got, want) / max(1.0, want.float().abs().max().item()
                                if want.numel() else 0.0)


def warm_ttft_ms(eng, prompts, reps: int = 3, enc_out=None) -> float:
    """Median time (ms) of prefill + first argmax, after the first call."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eng.prefill(prompts, enc_out)[1].argmax(-1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_env() -> str:
    """Prints, and returns, the card's name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
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
    return card


def card_state() -> str:
    """SM clock, its maximum, power draw and temperature, as nvidia-smi
    reads them: kernel times depend on them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    wall = time.perf_counter() - t0
    for name, rep in report.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                           rep["log"])]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                rep["log"]))
        print(f"[build] {name}.cu: {rep['seconds']:.2f}s, {len(regs)} "
              f"kernels, registers at most {max(regs, default=0)}, "
              f"{spills} bytes of spill stores")
    print(f"[build] all kernels built in {wall:.2f}s (parallel nvcc)")


def pump_sweep(label, run, check_one, built):
    """Every built pump case of one kernel on one input: ``run((factor,
    mode))`` returns its outputs (a tuple), ``check_one(outputs)`` their
    error against the plain version (checked by the caller's tolerance
    inside it); every case must give T1's bits.  Returns (cases run, worst
    error)."""
    base, worst, names = None, 0.0, []
    for f, m in PUMP_CASES:
        if not built(f, m):
            continue
        outs = run((f, m))
        worst = max(worst, check_one(outs, f"{label} {f}{m}"))
        if base is None:
            base = outs
        else:
            check(all(torch.equal(a, b_) for a, b_ in zip(outs, base)),
                  f"{label}: pump {f}{m} changed the bits of T1's result")
        names.append(f"{'T' if m == 'T' or f == 1 else 'R'}{f}")
    return names, worst


def pump_times(timer, label, run, built):
    """Kernel time (ms) of every built pump case at one shape."""
    times = {}
    for f, m in PUMP_CASES:
        if built(f, m):
            times[f"{m}{f}"] = timer.ms(lambda: run((f, m)))
    print(f"[{label}] per pump case: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()))
    return times


def phase_kernels(timer):
    """Each kernel against its plain version; returns the kernels entries."""
    from repro_torch.core.pump_plan import (PEAK_FLOPS_BF16, PEAK_FLOPS_FP32,
                                            bound_ms)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.timing import TIMING_ITERS, Timer
    gen = torch.Generator(device="cuda").manual_seed(1234)

    # (a) fp32, small ragged shapes: GQA, S / T not tile multiples, S != T,
    # head dims that are not a power of two; every built pump case within
    # ATOL_FP32 of the plain version (o; m and l relative), all with T1's
    # bits
    for b, h, hkv, s, t, d, causal in [
            (2, 4, 2, 37, 37, 64, True), (2, 4, 2, 37, 37, 64, False),
            (1, 4, 4, 100, 130, 32, False), (1, 6, 2, 130, 130, 128, True),
            (2, 4, 1, 70, 37, 32, True), (1, 2, 2, 5, 200, 128, False),
            (2, 4, 2, 300, 300, 8, True), (1, 2, 1, 65, 129, 36, False)]:
        q, k, v = (randn(gen, b, h, s, d), randn(gen, b, hkv, t, d),
                   randn(gen, b, hkv, t, d))
        want = ref.flash_attention(q, k, v, causal=causal, stats=True)

        def check_flash(outs, label, want=want):
            e = err(outs[0], want[0])
            e_ml = max(rel_err(outs[1], want[1]), rel_err(outs[2], want[2]))
            check(e <= ATOL_FP32 and e_ml <= ATOL_FP32,
                  f"{label}: o err {e}, m / l rel err {e_ml} > {ATOL_FP32}")
            return e
        cases, e = pump_sweep(
            f"flash fp32 D{d}",
            lambda pump: fa.flash_attention_cuda(q, k, v, causal=causal,
                                                 pump=pump, stats=True),
            check_flash, lambda f, m: fa.built(f, m, d, q.dtype))
        print(f"[flash fp32] B{b} H{h}/{hkv} S{s} T{t} D{d} causal={causal}: "
              f"{'/'.join(cases)}: max abs err {e:.3g}, m and l within "
              f"{ATOL_FP32} relative, identical bits")
    # decode attention also at a group of 8 heads (8 lane slots) and with a
    # bf16 cache at D 256 (a head spans two slots a lane), pos -1 included
    for b, h, hkv, t, d, pos, kv_dt in [
            (4, 8, 2, 37, 64, [0, 36, 17, 5], torch.float32),
            (3, 4, 4, 200, 128, [199, 0, 64], torch.float32),
            (2, 16, 8, 577, 128, [576, 511], torch.float32),
            (2, 4, 2, 300, 32, [299, 130], torch.float32),
            (2, 16, 2, 150, 128, [149, 40], torch.float32),
            (2, 4, 2, 130, 256, [129, -1], torch.bfloat16),
            # per-row lanes of a stream: a lane at 0, lanes on either side
            # of a 64-key tile, the last key, and free lanes past the end
            (6, 8, 2, 77, 64, [0, 63, 64, 76, 77, 90], torch.float32)]:
        q, k, v = (randn(gen, b, h, d), randn(gen, b, hkv, t, d, dtype=kv_dt),
                   randn(gen, b, hkv, t, d, dtype=kv_dt))
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        want = ref.decode_attention(q, k, v, p)

        def check_decode(outs, label, want=want):
            e = err(outs[0], want)
            check(e <= ATOL_FP32, f"{label}: err {e} > {ATOL_FP32}")
            return e
        cases, e = pump_sweep(
            f"decode fp32 D{d}",
            lambda pump: (da.decode_attention_cuda(q, k, v, p, pump=pump),),
            check_decode, lambda f, m: da.built(f, m, h // hkv, d, k.dtype))
        print(f"[decode fp32] B{b} H{h}/{hkv} T{t} D{d} pos={pos}, cache "
              f"{kv_dt}: {'/'.join(cases)}: max abs err {e:.3g}, identical "
              f"bits")

    # bf16 (the tensor-core body) at small ragged GQA shapes: S != T, S and
    # T not tile multiples, D 16 / 32 / 40 / 72 / 128 in all four padded
    # widths (16, 32, 64, 128) and D 44, whose odd rows take the 8-byte
    # copies; o within ATOL_BF16 of the
    # plain version, m and l within RTOL_FLASH_STATS_BF16, every built pump
    # case with T1's bits
    for b, h, hkv, s, t, d, causal in [
            (2, 4, 2, 37, 100, 40, True), (2, 4, 2, 37, 100, 40, False),
            (1, 4, 1, 130, 70, 72, True), (1, 4, 1, 130, 70, 72, False),
            (2, 4, 2, 100, 200, 128, True), (1, 2, 1, 200, 77, 128, False),
            (1, 4, 2, 65, 129, 44, True), (1, 4, 2, 70, 130, 16, True),
            (2, 2, 1, 64, 128, 32, False)]:
        q = randn(gen, b, h, s, d, dtype=torch.bfloat16)
        k = randn(gen, b, hkv, t, d, dtype=torch.bfloat16)
        v = randn(gen, b, hkv, t, d, dtype=torch.bfloat16)
        want = ref.flash_attention(q, k, v, causal=causal, stats=True)

        def check_flash_bf16(outs, label, want=want):
            e = err(outs[0], want[0])
            e_ml = max(rel_err(outs[1], want[1]), rel_err(outs[2], want[2]))
            check(e <= ATOL_BF16 and e_ml <= RTOL_FLASH_STATS_BF16,
                  f"{label}: o err {e} (atol {ATOL_BF16}), m / l rel err "
                  f"{e_ml} (rtol {RTOL_FLASH_STATS_BF16})")
            return e
        cases, e = pump_sweep(
            f"flash bf16 D{d}",
            lambda pump: fa.flash_attention_cuda(q, k, v, causal=causal,
                                                 pump=pump, stats=True),
            check_flash_bf16, lambda f, m: fa.built(f, m, d, q.dtype))
        print(f"[flash bf16] B{b} H{h}/{hkv} S{s} T{t} D{d} causal={causal}: "
              f"{'/'.join(cases)}: max abs err {e:.3g} (atol {ATOL_BF16}), "
              f"m and l within {RTOL_FLASH_STATS_BF16} relative, identical "
              f"bits")

    # (b) main-path shapes and dtypes
    b, h, hkv, s, d = 8, 16, 8, 512, 128
    q = randn(gen, b, h, s, d, dtype=torch.bfloat16)
    k = randn(gen, b, hkv, s, d, dtype=torch.bfloat16)
    v = randn(gen, b, hkv, s, d, dtype=torch.bfloat16)
    want = ref.flash_attention(q, k, v, causal=True)

    def check_fa(outs, label):
        e = err(outs[0], want)
        check(e <= ATOL_BF16, f"{label}: err {e} > {ATOL_BF16}")
        return e

    def run_fa(pump):
        return (fa.flash_attention_cuda(q, k, v, causal=True, pump=pump),)
    fa_built = lambda f, m: fa.built(f, m, d, q.dtype)  # noqa: E731
    cases, e_fa = pump_sweep("flash bf16", run_fa, check_fa, fa_built)
    print(f"[flash bf16] B{b} H{h}/{hkv} S=T={s} D{d} causal, "
          f"{'/'.join(cases)}: max abs err {e_fa:.3g} (atol {ATOL_BF16}), "
          f"identical bits")
    # T1 with no spin before the start event, first of the process and
    # again after the timings below: a late sample (start fired before the
    # host had queued the call) holds host time in its reading
    bare = Timer(hold_cycles=0)
    run_t1 = lambda: fa.flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
    bare_cold = bare.ms(run_t1)
    late_cold = bare.late
    fa_pumps = pump_times(timer, "flash bf16", run_fa, fa_built)
    pairs = sum(min(i + 1, s) for i in range(s))
    fa_bound, fa_by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                               4.0 * b * h * d * pairs, PEAK_FLOPS_BF16)
    print(f"[flash bf16] card before timing: {card_state()}")
    late0, samples0 = timer.late, timer.samples
    fa_ms = timer.ms(run_t1)
    late, samples = timer.late - late0, timer.samples - samples0
    bare_warm = bare.ms(run_t1)
    print(f"[flash bf16] timer: T1 {fa_ms:.4f} ms, late in {late}/{samples} "
          f"samples; with no hold before the start event {bare_cold:.4f} ms "
          f"first in the process (late in {late_cold}/{TIMING_ITERS}), "
          f"{bare_warm:.4f} ms here (late in {bare.late - late_cold}/"
          f"{TIMING_ITERS})")
    del bare
    fa_plain = timer.ms(lambda: ref.flash_attention(q, k, v, causal=True))
    fa_lib = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    fa_flops = 4.0 * b * h * d * pairs
    print(f"[flash bf16] kernel {fa_ms:.4f} ms "
          f"({fa_flops / fa_ms * 1e-9:.1f} TFLOP/s, {fa_ms / fa_lib:.2f}x "
          f"SDPA), plain {fa_plain:.4f} ms, SDPA {fa_lib:.4f} ms "
          f"({fa_flops / fa_lib * 1e-9:.1f} TFLOP/s), bound {fa_bound:.4f} "
          f"ms ({fa_by})")

    t, pos_main = 577, 575   # max_len of the e2e run; its deepest step
    qd = randn(gen, b, h, d, dtype=torch.bfloat16)
    kc, vc = randn(gen, b, hkv, t, d), randn(gen, b, hkv, t, d)
    pd = torch.full((b,), pos_main, dtype=torch.int32, device="cuda")
    want = ref.decode_attention(qd, kc, vc, pd)

    def check_da(outs, label):
        e = err(outs[0], want)
        check(e <= ATOL_BF16, f"{label}: err {e} > {ATOL_BF16}")
        return e

    def run_da(pump):
        return (da.decode_attention_cuda(qd, kc, vc, pd, pump=pump),)
    da_built = lambda f, m: da.built(f, m, h // hkv, d, kc.dtype)  # noqa: E731
    cases, e_da = pump_sweep("decode", run_da, check_da, da_built)
    print(f"[decode bf16] B{b} H{h}/{hkv} T{t} D{d} q bf16, cache fp32, "
          f"pos {pos_main}, {'/'.join(cases)}: max abs err {e_da:.3g} (atol "
          f"{ATOL_BF16}), identical bits")
    # per-row positions, as the stream's per-slot decode gives them: every
    # row at its own depth, row 7 a free lane past the end (pos >= T keeps
    # every key); every built pump case with T1's bits
    pr = torch.tensor(STREAM_ROW_POS, dtype=torch.int32, device="cuda")
    want_rows = ref.decode_attention(qd, kc, vc, pr)

    def check_rows(outs, label):
        e = err(outs[0], want_rows)
        check(e <= ATOL_BF16, f"{label}: err {e} > {ATOL_BF16}")
        return e
    cases, e_rows = pump_sweep(
        "decode per-row pos",
        lambda pump: (da.decode_attention_cuda(qd, kc, vc, pr, pump=pump),),
        check_rows, da_built)
    print(f"[decode bf16] per-row pos {STREAM_ROW_POS} (T {t}): "
          f"{'/'.join(cases)}: max abs err {e_rows:.3g} (atol {ATOL_BF16}), "
          f"identical bits; T1 "
          f"{timer.ms(lambda: da.decode_attention_cuda(qd, kc, vc, pr)):.4f}"
          f" ms")
    # the splits are a function of the shape alone, the same in the wrapper
    # and in the built kernel
    for shape in ((b, hkv, t, d, kc.dtype), (b, hkv, t, d, torch.bfloat16),
                  (2, 2, 200, 32, torch.float32), (1, 1, 64, 8, torch.float32),
                  (16, 8, t, d, kc.dtype)):
        check(da.splits(*shape) == da.kernel_splits(*shape),
              f"decode splits {shape}: wrapper {da.splits(*shape)}, kernel "
              f"{da.kernel_splits(*shape)}")
    n_split = da.splits(b, hkv, t, d, kc.dtype)
    print(f"[decode] splits at B{b} Hkv{hkv} T{t} D{d} fp32 cache: {n_split} "
          f"({b * hkv * n_split} blocks, clusters of {n_split}; wrapper and "
          f"kernel agree)")
    da_pumps = pump_times(timer, "decode", run_da, da_built)
    print("[decode] per pump case over T1: " + ", ".join(
        f"{k} {v / da_pumps['T1']:.2f}x" for k, v in da_pumps.items()))
    n_keys = b * (pos_main + 1)
    da_bound, da_by = bound_ms(
        2 * qd.numel() * 2 + pd.numel() * 4 + 2 * n_keys * hkv * d * 4,
        4.0 * h * d * n_keys, PEAK_FLOPS_FP32)
    # T1 at a short, a middle and the deepest pos: splits past pos load
    # nothing
    by_pos = {}
    for pv in (63, 319, pos_main):
        pp = torch.full((b,), pv, dtype=torch.int32, device="cuda")
        e = err(da.decode_attention_cuda(qd, kc, vc, pp),
                ref.decode_attention(qd, kc, vc, pp))
        check(e <= ATOL_BF16, f"decode pos {pv}: err {e} > {ATOL_BF16}")
        by_pos[pv] = timer.ms(lambda: da.decode_attention_cuda(qd, kc, vc, pp))
        pos_bound = bound_ms(2 * qd.numel() * 2 + pp.numel() * 4
                             + 2 * b * (pv + 1) * hkv * d * 4,
                             4.0 * h * d * b * (pv + 1), PEAK_FLOPS_FP32)[0]
        print(f"[decode] T1 at pos {pv}: {by_pos[pv]:.4f} ms, bound "
              f"{pos_bound:.4f} ms, max abs err {e:.3g}")
    da_ms = timer.ms(lambda: da.decode_attention_cuda(qd, kc, vc, pd))
    # what the timer itself adds to a call this short: its floor (a
    # one-element add), and T1 after a flush that leaves L2 clean, where
    # the call writes back none of the flush's dirty lines
    one = torch.zeros(1, device="cuda")
    clean = Timer(read_flush=True)
    print(f"[decode] T1 {da_ms:.4f} ms after the timer's writing flush, "
          f"{clean.ms(lambda: da.decode_attention_cuda(qd, kc, vc, pd)):.4f}"
          f" ms after a reading one; the timer's floor (a one-element add) "
          f"{timer.ms(lambda: one.add_(1)):.4f} / "
          f"{clean.ms(lambda: one.add_(1)):.4f} ms")
    del clean
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
         "bound_ms": fa_bound, "bound_by": fa_by, "library_ms": fa_lib,
         "pump_ms": fa_pumps},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/compiler/pallas_backend.py:784",
         "max_abs_err": e_da, "ms": da_ms, "plain_ms": da_plain,
         "bound_ms": da_bound, "bound_by": da_by, "library_ms": da_lib,
         "pump_ms": da_pumps},
    ]


def ssd_inputs(gen, b, l, h, g, n, p, dtype=torch.float32):
    """x, dt, A, B, C as the model makes them: x, B and C strided views of
    one (B, L, H·P + 2·G·N) conv output, dt = softplus(·), A =
    -linspace(1, 16, H)."""
    conv = torch.nn.functional.silu(randn(gen, b, l, h * p + 2 * g * n))
    conv = conv.to(dtype)
    x = conv[..., :h * p].reshape(b, l, h, p)
    bm = conv[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = conv[..., h * p + g * n:].reshape(b, l, g, n)
    dt = F.softplus(randn(gen, b, l, h)).to(dtype)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, a, bm, cm


def phase_ssd_kernels(timer):
    """The SSD scan and decode kernels against their plain versions;
    returns their kernels entries."""
    from repro_torch.core.pump_plan import (HBM_BW, PEAK_FLOPS_BF16,
                                            PEAK_FLOPS_FP32, bound_ms)
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_decode as sd
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(4321)

    # (c) the SSD scan, fp32, ragged L, grouped B / C, every built pump
    # case under RTOL_SSD_FP32, all with T1's bits
    for b, l, h, g, n, p, chunk in [
            (2, 37, 4, 1, 16, 32, 16), (1, 100, 8, 2, 64, 64, 64),
            (2, 130, 4, 2, 128, 64, 64), (1, 130, 6, 1, 32, 16, 16),
            (2, 100, 8, 1, 128, 64, 16), (1, 37, 4, 2, 128, 64, 64),
            (1, 200, 4, 2, 24, 40, 32)]:
        x, dt, a, bm, cm = ssd_inputs(gen, b, l, h, g, n, p)
        y_ref, st_ref = ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                     final_state=True)

        def check_scan(outs, label, y_ref=y_ref, st_ref=st_ref):
            e = max(rel_err(outs[0], y_ref), rel_err(outs[1], st_ref))
            check(e <= RTOL_SSD_FP32,
                  f"{label}: rel err {e} > {RTOL_SSD_FP32}")
            return e
        cases, e = pump_sweep(
            "ssd_scan fp32",
            lambda pump: ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=chunk,
                                          final_state=True, pump=pump),
            check_scan, ss.built)
        print(f"[ssd_scan fp32] B{b} L{l} H{h} G{g} N{n} P{p} chunk {chunk}: "
              f"{'/'.join(cases)}: rel err {e:.3g}, identical bits")
    e_y = rel_err(ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=64), y_ref)
    check(e_y <= RTOL_SSD_FP32, f"ssd_scan without state: rel err {e_y}")
    # the same shapes in bf16 (the tensor-core body: rows, columns and
    # chunks zero-padded to 16-wide tiles), and P 36 (rows of 72 bytes: the
    # element-wise staging) and chunk 40; y within RTOL_SSD_BF16, the state
    # within RTOL_SSD_FP32, every built pump case with T1's bits
    for b, l, h, g, n, p, chunk in [
            (2, 37, 4, 1, 16, 32, 16), (1, 100, 8, 2, 64, 64, 64),
            (2, 130, 4, 2, 128, 64, 64), (1, 130, 6, 1, 32, 16, 16),
            (2, 100, 8, 1, 128, 64, 16), (1, 37, 4, 2, 128, 64, 64),
            (1, 200, 4, 2, 24, 40, 32), (1, 100, 4, 2, 24, 36, 40),
            (2, 70, 4, 1, 40, 48, 64)]:
        x, dt, a, bm, cm = ssd_inputs(gen, b, l, h, g, n, p, torch.bfloat16)
        y_ref, st_ref = ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                     final_state=True)

        def check_tc(outs, label, y_ref=y_ref, st_ref=st_ref):
            e_y, e_s = rel_err(outs[0], y_ref), rel_err(outs[1], st_ref)
            check(e_y <= RTOL_SSD_BF16, f"{label}: y rel err {e_y}")
            check(e_s <= RTOL_SSD_FP32, f"{label}: state rel err {e_s}")
            return e_s
        cases, e = pump_sweep(
            "ssd_scan bf16",
            lambda pump: ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=chunk,
                                          final_state=True, pump=pump),
            check_tc, ss.built)
        print(f"[ssd_scan bf16] B{b} L{l} H{h} G{g} N{n} P{p} chunk {chunk}: "
              f"{'/'.join(cases)}: state rel err {e:.3g}, identical bits")

    # the mamba2-1.3b path: B 8, L 512, 64 heads x 64, N 128, G 1, chunk 64
    b, l, h, g, n, p, chunk = 8, 512, 64, 1, 128, 64, 64
    x, dt, a, bm, cm = ssd_inputs(gen, b, l, h, g, n, p, torch.bfloat16)
    y_ref, st_ref = ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                 final_state=True)

    def check_scan(outs, label):
        e_y, e_s = rel_err(outs[0], y_ref), rel_err(outs[1], st_ref)
        check(e_y <= RTOL_SSD_BF16, f"{label}: y rel err {e_y}")
        check(e_s <= RTOL_SSD_FP32, f"{label}: state rel err {e_s}")
        return max(err(outs[0], y_ref), err(outs[1], st_ref))

    def run_scan(pump):
        return ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=chunk,
                                final_state=True, pump=pump)
    cases, e_scan = pump_sweep("ssd_scan bf16", run_scan, check_scan,
                               ss.built)
    y, st = run_scan(1)
    e_y, e_s = rel_err(y, y_ref), rel_err(st, st_ref)
    print(f"[ssd_scan bf16] B{b} L{l} H{h} G{g} N{n} P{p} chunk {chunk}, "
          f"{'/'.join(cases)}: rel err y {e_y:.3g} (rtol "
          f"{RTOL_SSD_BF16:.3g}), state {e_s:.3g} (rtol {RTOL_SSD_FP32}); "
          f"max abs err {e_scan:.3g}, identical bits")
    ss_pumps = pump_times(timer, "ssd_scan", run_scan, ss.built)
    # bytes: each input read once, y and the state written once.  The
    # products: the causal half of C·Bᵀ once per (b, group, chunk), since
    # the heads of a group share it, and per (b, h, chunk) C·S, the causal
    # half of G·x and the state update.  The kernel issues them on the
    # tensor cores as bf16 terms (ss.TERMS: C·Bᵀ one on bf16 inputs, C·S
    # and G·x two, the state's three), so their bound is the terms' FLOP
    # at the bf16 peak; bound_ms is the larger of that and the bytes'.  The
    # same products as fp32 FMAs (the CUDA-core body, and the figure of
    # earlier PRs) are printed beside it.
    tri = chunk * (chunk + 1) // 2
    per = b * (l // chunk) * 2
    prods = {"C.B^T": per * g * tri * n, "C.S": per * h * chunk * p * n,
             "G.x": per * h * tri * p, "state": per * h * n * p * chunk}
    flops = sum(prods.values())
    tc_flops = sum(v * ss.TERMS[k] for k, v in prods.items())
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, a, bm, cm, y,
                                                         st))
    bytes_ms = nbytes / HBM_BW * 1e3
    tc_ms = tc_flops / PEAK_FLOPS_BF16 * 1e3
    fma_ms = flops / PEAK_FLOPS_FP32 * 1e3
    ss_bound, ss_by = bound_ms(nbytes, tc_flops, PEAK_FLOPS_BF16)
    ss_ms = timer.ms(lambda: ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=chunk,
                                              final_state=True))
    ss_plain = timer.ms(lambda: ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                             final_state=True))
    per_sm = {f"{m}{f}": ss.blocks_per_sm(f, m) for f, m in PUMP_CASES
              if ss.built(f, m)}
    print(f"[ssd_scan] kernel {ss_ms:.4f} ms, plain {ss_plain:.4f} ms, bound "
          f"{ss_bound:.4f} ms ({ss_by}): bytes {nbytes / 1e6:.1f} MB "
          f"{bytes_ms:.4f} ms; tensor cores {tc_flops / 1e9:.2f} GFLOP of "
          f"bf16 terms {tc_ms:.4f} ms ({flops / 1e9:.2f} GFLOP of products, "
          f"{flops / PEAK_FLOPS_BF16 * 1e3:.4f} ms a term); fp32 FMAs "
          f"{fma_ms:.4f} ms")
    print("[ssd_scan] split (bf16 terms a product): "
          + ", ".join(f"{k} {v}" for k, v in ss.TERMS.items())
          + "; blocks per SM (runtime): "
          + ", ".join(f"{k} {v}" for k, v in per_sm.items())
          + f"; CUDA-core body (fp32 inputs) T1 "
          f"{ss.blocks_per_sm(1, 'T', tensor_cores=False)}")

    # (d) the SSD decode step, fp32, grouped B / C, strided views
    for b, h, g, n, p in [(1, 4, 1, 16, 32), (3, 8, 2, 64, 64),
                          (2, 6, 2, 128, 64), (2, 4, 4, 128, 16)]:
        x, dt, a, bm, cm = ssd_inputs(gen, b, 1, h, g, n, p)
        x, dt, bm, cm = x[:, 0], dt[:, 0], bm[:, 0], cm[:, 0]
        st = randn(gen, b, h, n, p)
        y, st2 = sd.ssd_decode_cuda(st, x, dt, a, bm, cm)
        y_ref, st2_ref = ref.ssd_decode(st, x, dt, a, bm, cm)
        e_y, e_s = rel_err(y, y_ref), rel_err(st2, st2_ref)
        print(f"[ssd_decode fp32] B{b} H{h} G{g} N{n} P{p}: rel err y "
              f"{e_y:.3g}, state {e_s:.3g}")
        check(max(e_y, e_s) <= RTOL_SSD_FP32,
              f"ssd_decode fp32 rel err {max(e_y, e_s)} > {RTOL_SSD_FP32}")

    b, h, g, n, p = 8, 64, 1, 128, 64
    x, dt, a, bm, cm = ssd_inputs(gen, b, 1, h, g, n, p, torch.bfloat16)
    x, dt, bm, cm = x[:, 0], dt[:, 0], bm[:, 0], cm[:, 0]
    st = randn(gen, b, h, n, p)
    y, st2 = sd.ssd_decode_cuda(st, x, dt, a, bm, cm)
    y_ref, st2_ref = ref.ssd_decode(st, x, dt, a, bm, cm)
    e_y, e_s = rel_err(y, y_ref), rel_err(st2, st2_ref)
    e_dec = max(err(y, y_ref), err(st2, st2_ref))
    print(f"[ssd_decode bf16] B{b} H{h} G{g} N{n} P{p}, x / dt / B / C bf16, "
          f"state fp32: rel err y {e_y:.3g}, state {e_s:.3g} (rtol "
          f"{RTOL_SSD_FP32}); max abs err {e_dec:.3g}")
    check(max(e_y, e_s) <= RTOL_SSD_FP32,
          f"ssd_decode rel err {max(e_y, e_s)} > {RTOL_SSD_FP32}")
    nbytes = sum(t.numel() * t.element_size() for t in (st, x, dt, a, bm, cm,
                                                         y, st2))
    sd_bound, sd_by = bound_ms(nbytes, 5.0 * b * h * n * p,
                               PEAK_FLOPS_FP32)
    sd_ms = timer.ms(lambda: sd.ssd_decode_cuda(st, x, dt, a, bm, cm))
    sd_plain = timer.ms(lambda: ref.ssd_decode(st, x, dt, a, bm, cm))
    print(f"[ssd_decode] kernel {sd_ms:.4f} ms, plain {sd_plain:.4f} ms, "
          f"bound {sd_bound:.4f} ms ({sd_by}: {nbytes / 1e6:.1f} MB)")
    print(f"[ssd_decode] host time per call: kernel wrapper "
          f"{host_us(lambda: sd.ssd_decode_cuda(st, x, dt, a, bm, cm)):.1f} "
          f"µs, plain {host_us(lambda: ref.ssd_decode(st, x, dt, a, bm, cm)):.1f}"
          f" µs")

    return [
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:97",
         "max_abs_err": e_scan, "ms": ss_ms, "plain_ms": ss_plain,
         "bound_ms": ss_bound, "bound_by": ss_by, "library_ms": None,
         "pump_ms": ss_pumps},
        {"name": "ssd_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_decode.cu",
         "replaces": "src/repro/compiler/pallas_backend.py:814",
         "max_abs_err": e_dec, "ms": sd_ms, "plain_ms": sd_plain,
         "bound_ms": sd_bound, "bound_by": sd_by, "library_ms": None},
    ]


def phase_paper_kernels(timer):
    """(e) vecadd, (f) matmul, (g) the stencil stage, (h) Floyd-Warshall
    against their plain versions: fp32 at small ragged shapes for every
    pump case, then the paper tables' card sizes with kernel, plain,
    library and bound times.  Returns their kernels entries."""
    from repro_torch.core.ir import PumpSpec
    from repro_torch.core.pump_plan import (PEAK_FLOPS_FP32, PEAK_OPS_FP32,
                                            bound_ms)
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels import vecadd as va
    from repro_torch.launch import paper
    from repro_torch.launch.timing import TIMING_ITERS
    gen = torch.Generator(device="cuda").manual_seed(2024)
    pumps = [PumpSpec(1), PumpSpec(2), PumpSpec(4), PumpSpec(2, "R")]

    def ints(*shape, dtype=torch.float32):
        """Integer values in [-4, 4]: every partial sum of a product is an
        exact fp32 integer, so matmul must agree exactly."""
        return torch.randint(-4, 5, shape, generator=gen,
                             device="cuda").to(dtype)

    # (e) vecadd: ragged lengths, V 2 / 4 / 8 in every pump case, fp32 and
    # bf16, exact (both round one add once)
    worst = 0.0
    dp = PumpSpec(2, "R")
    for n in (1, 37, 100, 4099, 1000003):
        for dtype in (torch.float32, torch.bfloat16):
            x, y = randn(gen, n, dtype=dtype), randn(gen, n, dtype=dtype)
            want = ref.vecadd(x, y)
            for v in (2, 4, 8):
                for spec in pumps + [PumpSpec(4, "R")]:
                    if spec.mode == "R" and v % spec.factor:
                        continue
                    e = err(va.vecadd_cuda(x, y, vector_width=v, pump=spec),
                            want)
                    worst = max(worst, e)
                    check(e == 0, f"vecadd n={n} {dtype} V={v} {spec}: "
                                  f"max abs err {e}")
            if dtype == torch.bfloat16:  # 128-byte transactions, W 64
                for v, spec in ((16, PumpSpec(4)), (64, PumpSpec(4, "R"))):
                    e = err(va.vecadd_cuda(x, y, vector_width=v, pump=spec),
                            want)
                    worst = max(worst, e)
                    check(e == 0, f"vecadd n={n} {dtype} V={v} {spec}: "
                                  f"max abs err {e}")
    print(f"[vecadd] n 1 / 37 / 100 / 4099 / 1000003, fp32 and bf16, V 2-8, "
          f"M 1 / 2 / 4 T and 2 / 4 R, and bf16 V 16 M 4 T / V 64 M 4 R: "
          f"max abs err {worst} (exact)")
    n = paper.CARD["vecadd_n"]
    x, y = randn(gen, n), randn(gen, n)
    before = va.launches
    e_va = err(va.vecadd_cuda(x, y, vector_width=8, pump=dp), ref.vecadd(x, y))
    check(e_va == 0, f"vecadd card size: max abs err {e_va}")
    check(va.launches - before == 1, "vecadd: one launch a call")
    va_bound, va_by = bound_ms(3 * n * 4, n, PEAK_OPS_FP32)
    # every Table 2 row, between two readings of torch.add
    va_libs = [timer.ms(lambda: torch.add(x, y))]
    rows = {}
    for v in (2, 4, 8):
        for label, spec in (("O", PumpSpec(1)), ("DP", dp)):
            rows[f"V{v} {label}"] = timer.ms(
                lambda: va.vecadd_cuda(x, y, vector_width=v, pump=spec))
    va_libs.append(timer.ms(lambda: torch.add(x, y)))
    va_lib = statistics.mean(va_libs)
    va_ms = rows["V8 DP"]
    print(f"[vecadd] N 2^28 fp32, 1 launch a call: " + ", ".join(
        f"{k} {t:.4f} ms ({t / va_lib:.3f}x torch.add)"
        for k, t in rows.items()) + "; DP/O " + ", ".join(
        f"V{v} {rows[f'V{v} DP'] / rows[f'V{v} O']:.3f}" for v in (2, 4, 8))
        + f"; torch.add {va_libs[0]:.4f} / {va_libs[1]:.4f} ms")
    va_plain = timer.ms(lambda: ref.vecadd(x, y))
    print(f"[vecadd] V 8 DP: plain {va_plain:.4f} ms, bound "
          f"{va_bound:.4f} ms ({va_by}); max abs err {e_va}")
    del x, y

    # (f) matmul: ragged and unaligned M, N, K; both tiles, every pump
    # case; integer values (exact) in fp32 and bf16, normal values under
    # RTOL_MATMUL
    worst = 0.0
    for m, k, n in ((100, 70, 50), (37, 129, 65), (64, 64, 64),
                    (130, 33, 200), (1, 300, 7)):
        for dtype in (torch.float32, torch.bfloat16):
            a, b = ints(m, k, dtype=dtype), ints(k, n, dtype=dtype)
            want = ref.matmul(a, b, out_dtype=dtype)
            for bn in (64, 128):
                for spec in pumps + [PumpSpec(4, "R")]:
                    e = err(mm.matmul_cuda(a, b, bm=64, bn=bn, bk=32,
                                           pump=spec), want)
                    worst = max(worst, e)
                    check(e == 0, f"matmul {m}x{k}x{n} {dtype} bn {bn} "
                                  f"{spec}: max abs err {e}")
        a, b = randn(gen, m, k), randn(gen, k, n)
        e = rel_err(mm.matmul_cuda(a, b, pump=PumpSpec(2, "R")),
                    ref.matmul(a, b))
        check(e <= paper.RTOL_MATMUL, f"matmul {m}x{k}x{n} normal: rel {e}")
    print(f"[matmul] integer-valued fp32 / bf16 at 100x70x50, 37x129x65, "
          f"64^3, 130x33x200, 1x300x7, tiles 64x64 / 64x128 x 32, M 1 / 2 / "
          f"4 T and 2 / 4 R: max abs err {worst} (exact)")
    size = paper.CARD["mm"]
    a, b = randn(gen, size, size), randn(gen, size, size)
    want = ref.matmul(a, b)
    cases, base = {}, None
    for name, bn, spec in paper.TABLE3_CASES:
        out = mm.matmul_cuda(a, b, bm=paper.BM, bn=bn, bk=paper.BK, pump=spec)
        e = rel_err(out, want)
        check(e <= paper.RTOL_MATMUL,
              f"{name} {size}^3: rel err {e} > {paper.RTOL_MATMUL}")
        # every case sums each output's K products in k order: O's bits
        base = out if base is None else base
        check(torch.equal(out, base),
              f"{name} {size}^3: not the bits of {paper.TABLE3_CASES[0][0]}")
        ms = timer.ms(lambda: mm.matmul_cuda(a, b, bm=paper.BM, bn=bn,
                                             bk=paper.BK, pump=spec))
        cases[name] = (ms, e, err(out, want))
    print(f"[matmul] card after timing: {card_state()}")
    mm_ms, mm_rel, e_mm = cases["mmm_32PE_DP"]
    mm_bound, mm_by = bound_ms(3 * size * size * 4, 2.0 * size ** 3,
                               PEAK_FLOPS_FP32)
    mm_plain = timer.ms(lambda: ref.matmul(a, b))
    mm_lib = timer.ms(lambda: torch.matmul(a, b))
    print(f"[matmul] {size}^3 fp32: " + ", ".join(
        f"{k} {v[0]:.4f} ms ({2.0 * size ** 3 / v[0] * 1e-9:.1f} TFLOP/s, "
        f"rel err {v[1]:.3g})" for k, v in cases.items())
        + f", identical bits; plain {mm_plain:.4f} ms, torch.matmul "
        f"{mm_lib:.4f} ms ({mm_ms / mm_lib:.2f}x for DP), bound "
        f"{mm_bound:.4f} ms ({mm_by}; rtol {paper.RTOL_MATMUL})")
    del a, b, want, base, out

    # (g) stencil: ragged planes and tiles (rows not 16-byte aligned, tiles
    # ragged in x and y), both kinds, M 1 / 2 / 4 / 8 (32-, 16- and 8-row
    # tiles), 1 and 3 stages: the plain version's bits (the same operations
    # in the same order, rounded to nearest)
    for shape in ((10, 8, 8), (18, 16, 16), (6, 37, 70), (34, 33, 65),
                  (4, 3, 3), (18, 70, 300), (10, 40, 520)):
        x = randn(gen, *shape)
        for kind in ("jacobi", "diffusion"):
            for stages in (1, 3):
                want = ref.stencil_chain(x, stages, kind=kind)
                for m in (1, 2, 4, 8):
                    if (shape[0] - 2) % m:
                        continue
                    got = st.stencil_chain_cuda(x, stages, kind=kind, pump=m)
                    check(same_bits(got, want),
                          f"stencil {shape} {kind} S{stages} M{m}: not the "
                          f"plain version's bits (max abs err "
                          f"{err(got, want)})")
    print("[stencil] (10,8,8), (18,16,16), (6,37,70), (34,33,65), (4,3,3), "
          "(18,70,300), (10,40,520), jacobi and diffusion, S 1 / 3, M 1 / 2 "
          "/ 4 / 8: the plain version's bits")
    # card size: M 1, 2 and 4 of both kinds, exact, each timed beside the
    # bound, the plain version and a copy of the volume (one read and one
    # write of it, what the bound counts); conv3d for jacobi's interior
    shape = paper.CARD["volume"]
    x = randn(gen, *shape)
    interior = (shape[0] - 2) * (shape[1] - 2) * (shape[2] - 2)
    before = st.launches
    stage_ms = {}
    for kind in ("jacobi", "diffusion"):
        want = ref.stencil_chain(x, 1, kind=kind)
        bound = bound_ms(2 * x.numel() * 4,
                         paper.STENCIL_OPS[kind] * interior, PEAK_OPS_FP32)
        for m in (1, 2, 4):
            got = st.stencil_chain_cuda(x, 1, kind=kind, pump=m)
            check(same_bits(got, want), f"stencil card size {kind} M{m}: "
                  f"not the plain version's bits (max abs err "
                  f"{err(got, want)})")
            if (kind, m) == ("jacobi", 2):
                e_st = err(got, want)
            stage_ms[kind, m] = timer.ms(
                lambda: st.stencil_chain_cuda(x, 1, kind=kind, pump=m))
        plain = timer.ms(lambda: ref.stencil_chain(x, 1, kind=kind))
        plans = {m: st.plan(*shape, m, st.blocks_per_sm(x.device, m))
                 for m in (1, 2, 4)}
        print(f"[stencil] {kind} stage on {shape} fp32, the plain version's "
              f"bits: " + ", ".join(
                  f"M {m} {stage_ms[kind, m]:.4f} ms ({p.rows}-row tiles, "
                  f"{p.segments} segments)" for m, p in plans.items())
              + f"; DP/O {stage_ms[kind, 2] / stage_ms[kind, 1]:.3f}; plain "
              f"{plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        if kind == "jacobi":
            st_plain, (st_bound, st_by) = plain, bound
    check(st.launches - before == 6 * (2 + TIMING_ITERS),
          f"stencil: {st.launches - before} launches for "
          f"{6 * (2 + TIMING_ITERS)} stages")
    st_ms = stage_ms["jacobi", 2]
    dst = torch.empty_like(x)
    st_copy = timer.ms(lambda: dst.copy_(x))
    # the interior of one jacobi stage as one cuDNN convolution (boundary
    # not copied), TF32 off
    w = torch.zeros(1, 1, 3, 3, 3, device="cuda")
    for i, j, k in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                    (1, 1, 2), (1, 1, 1)):
        w[0, 0, i, j, k] = 1.0 / 7.0
    x5 = x[None, None]
    st_lib = timer.ms(lambda: F.conv3d(x5, w))
    print(f"[stencil] jacobi DP (M 2) {st_ms:.4f} ms, {st_bound / st_ms:.0%} "
          f"of the bound; a copy of the volume (Tensor.copy_) {st_copy:.4f} "
          f"ms; conv3d (interior) {st_lib:.4f} ms; one launch a stage")
    del x, x5, want, got, dst

    # (h) Floyd-Warshall: every M dividing n up to 16, bit-exact (NaN at the
    # same places), n that 64-pivot rounds do not divide, and the launches
    # of every call counted
    def fw_run(d, m):
        before = fw.launches
        out = fw.floyd_warshall_cuda(d, pump=m)
        want_l = fw.launches_per_call(d.shape[0], m)
        check(fw.launches - before == want_l,
              f"floyd_warshall n={d.shape[0]} M={m}: launches moved by "
              f"{fw.launches - before}, not {want_l}")
        return out

    for n, ms_ in ((37, (1,)), (8, (1, 2, 4, 8)), (100, (1, 2, 4)),
                   (128, (1, 2, 4, 8, 16)), (500, (1, 2, 4)),
                   (1000, (1, 8))):
        d = paper.distances(n, gen, torch.device("cuda"))
        want = ref.floyd_warshall(d)
        for m in ms_:
            check(same_bits(fw_run(d, m), want),
                  f"floyd_warshall n={n} M={m}: not the plain version's bits")
    for n in (100, 500):
        for kind in FW_KINDS[1:]:
            d = fw_graph(n, kind, seed=n).cuda()
            want = ref.floyd_warshall(d)
            for m in fw.PUMPS:
                if n % m == 0:
                    check(same_bits(fw_run(d, m), want),
                          f"floyd_warshall {kind} n={n} M={m}: not the plain "
                          f"version's bits")
    print("[floyd_warshall] n 37 (M 1), 8 (M 1-8), 100 (M 1-4), 128 (M "
          "1-16), 500 (M 1-4), 1000 (M 1, 8) uniform, and n 100 / 500 with "
          "30% inf, negative weights on a DAG and a NaN, every M dividing "
          "n: bit-exact, launches as launches_per_call")
    n = paper.CARD["fw"][-1]
    d = paper.distances(n, gen, torch.device("cuda"))
    want = ref.floyd_warshall(d)
    for m in fw.PUMPS:
        out = fw_run(d, m)
        check(same_bits(out, want),
              f"floyd_warshall n={n} M={m}: not the plain version's bits")
        if m == 2:
            e_fw = err(out, want)
    del out
    fw_bound, fw_by = bound_ms(2 * n * n * 4, 2.0 * n ** 3, PEAK_OPS_FP32)
    fw_times = {m: timer.ms(lambda: fw.floyd_warshall_cuda(d, pump=m),
                            iters=5) for m in fw.PUMPS}
    fw_ms = fw_times[2]
    fw_plain = timer.ms(lambda: ref.floyd_warshall(d), iters=2)
    # where one DP call's device time goes: the panels (phases 1-2) and the
    # update (phase 3), summed over the call's rounds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fw.floyd_warshall_cuda(d, pump=2)
        torch.cuda.synchronize()
    split = {k: sum(e.device_time_total / 1e3
                    for e in prof.key_averages() if k in e.key)
             for k in ("fw_panels", "fw_update")}
    # a profiler that records no device time gives sums of 0: not a time
    print(f"[floyd_warshall] n {n} DP, device time of one call by kernel: "
          + ", ".join(f"{k} {v:.4f} ms" if v > 0 else f"{k} not measured"
                      for k, v in split.items()))
    print(f"[floyd_warshall] n {n} fp32, {fw.launches_per_call(n)} launches "
          f"a call: " + ", ".join(f"M {m} {t:.4f} ms"
                                  for m, t in fw_times.items())
          + f"; DP/O {fw_ms / fw_times[1]:.3f}; plain {fw_plain:.4f} ms, "
          f"bound {fw_bound:.4f} ms ({fw_by}); max abs err {e_fw}")
    n = paper.CARD["fw"][0]
    d = paper.distances(n, gen, torch.device("cuda"))
    small = {m: timer.ms(lambda: fw.floyd_warshall_cuda(d, pump=m))
             for m in (1, 2)}
    print(f"[floyd_warshall] n {n} fp32, {fw.launches_per_call(n)} launches "
          f"a call: O {small[1]:.4f} ms, DP {small[2]:.4f} ms, bound "
          f"{bound_ms(2 * n * n * 4, 2.0 * n ** 3, PEAK_OPS_FP32)[0]:.4f} ms")
    del d, want

    return [
        {"name": "vecadd", "route": "cuda",
         "source": "src/repro_torch/csrc/vecadd.cu",
         "replaces": "src/repro/kernels/vecadd.py:64",
         "max_abs_err": e_va, "ms": va_ms, "plain_ms": va_plain,
         "bound_ms": va_bound, "bound_by": va_by, "library_ms": va_lib},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:97",
         "max_abs_err": e_mm, "ms": mm_ms, "plain_ms": mm_plain,
         "bound_ms": mm_bound, "bound_by": mm_by, "library_ms": mm_lib},
        {"name": "stencil", "route": "cuda",
         "source": "src/repro_torch/csrc/stencil.cu",
         "replaces": "src/repro/kernels/stencil.py:77",
         "max_abs_err": e_st, "ms": st_ms, "plain_ms": st_plain,
         "bound_ms": st_bound, "bound_by": st_by, "library_ms": st_lib},
        {"name": "floyd_warshall", "route": "cuda",
         "source": "src/repro_torch/csrc/floyd_warshall.cu",
         "replaces": "src/repro/kernels/floyd_warshall.py:63",
         "max_abs_err": e_fw, "ms": fw_ms, "plain_ms": fw_plain,
         "bound_ms": fw_bound, "bound_by": fw_by, "library_ms": None},
    ]


def expert_weights(gen, e: int, d: int, f: int) -> torch.Tensor:
    """(E, D, F) bf16 expert weights, normal / sqrt(D); above 2^28
    elements drawn 16 experts at a time (deepseek-v3's whole stack is 15 GB
    in fp32)."""
    step = e if e * d * f <= 1 << 28 else 16
    w = torch.empty(e, d, f, device="cuda", dtype=torch.bfloat16)
    for i in range(0, e, step):
        w[i:i + step] = (randn(gen, min(step, e - i), d, f) / d ** 0.5).to(
            torch.bfloat16)
    return w


def routed_layout(gen, tokens: int, e: int = 64, k: int = 6, d: int = 2048):
    """The ragged route's layout for a top-k routing of ``tokens`` seeded
    hidden states through a seeded router, as ``models.moe`` builds it:
    (assignment rows, padded group sizes, tile table, buffer rows)."""
    from repro_torch.models import moe
    x = randn(gen, tokens, d)
    probs = torch.softmax(x @ (randn(gen, d, e) / d ** 0.5), dim=-1)
    return moe.ragged_layout(torch.topk(probs, k, dim=-1)[1], e)


def phase_grouped_gemm(timer):
    """(i) the grouped GEMM against its plain version: fp32 at small ragged
    shapes in every pump case (empty experts, one-row groups, ragged C, F
    and D in the dense form, surplus tiles of a worst-case table), then the
    deepseek-v2-lite and deepseek-v3 MoE paths' shapes in bf16.  Returns
    its kernels entry."""
    from repro_torch.core.ir import PumpSpec
    from repro_torch.core.pump_plan import PEAK_FLOPS_BF16, bound_ms
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(77)
    pumps = [PumpSpec(1), PumpSpec(2), PumpSpec(4), PumpSpec(2, "R"),
             PumpSpec(4, "R")]

    def ints(*shape, dtype=torch.float32):
        """Integer values in [-4, 4]: every partial sum is an exact fp32
        integer, so any summation order gives the same result."""
        return torch.randint(-4, 5, shape, generator=gen,
                             device="cuda").to(dtype)

    def sweep(run, want, label, exact, dtype=torch.float32):
        worst = 0.0
        for bc, bf, bd in gg.TILES[dtype]:
            for spec in pumps:
                got = run(bc=bc, bf=bf, bd=bd, pump=spec)
                e = err(got, want) if exact else rel_err(got, want)
                worst = max(worst, e)
                check(e <= (0.0 if exact else ATOL_FP32),
                      f"grouped_gemm {label} tile {(bc, bf, bd)} {spec}: "
                      f"{'max abs' if exact else 'rel'} err {e}")
        return worst

    # ragged groups: empty experts, one-row groups, groups that are not
    # row-tile multiples, unaligned D and F
    worst = 0.0
    for sizes, d, f in (([5, 0, 12, 3], 70, 50), ([1, 1, 0, 33], 33, 130),
                        ([0, 0, 0, 17], 64, 128), ([40, 16, 1, 0, 7], 129, 65),
                        ([0, 0], 8, 8)):
        e = len(sizes)
        for dtype in (torch.float32, torch.bfloat16):
            for exact in (True, False):
                if not exact and dtype != torch.float32:
                    continue
                mk = ints if exact else (lambda *s, dtype: randn(gen, *s))
                x, w = mk(sum(sizes), d, dtype=dtype), mk(e, d, f, dtype=dtype)
                want = ops.grouped_gemm(x.cpu(), w.cpu(), group_sizes=sizes)
                worst = max(worst, sweep(
                    lambda **kw: ops.grouped_gemm(x, w, group_sizes=sizes,
                                                  **kw).cpu(),
                    want, f"sizes {sizes} D{d} F{f} {dtype}", exact, dtype))
    # the dense form: ragged C, F and D
    for e, c, d, f in ((3, 37, 70, 50), (2, 16, 64, 128), (5, 1, 300, 7),
                       (4, 130, 33, 200)):
        for dtype in (torch.float32, torch.bfloat16):
            x, w = ints(e, c, d, dtype=dtype), ints(e, d, f, dtype=dtype)
            want = ref.grouped_gemm(x, w)
            worst = max(worst, sweep(
                lambda **kw: ops.grouped_gemm(x, w, **kw), want,
                f"dense E{e} C{c} D{d} F{f} {dtype}", True, dtype))
    # a worst-case table built on the card: surplus tiles zero their rows
    rows, padded, tiles, n_rows = routed_layout(gen, 40, e=8, k=2, d=64)
    x, w = randn(gen, n_rows, 64), randn(gen, 8, 64, 96)
    want = ref.ragged_grouped_gemm(x, w, tiles)
    worst = max(worst, sweep(
        lambda **kw: ops.grouped_gemm(x, w, tiles=tiles, **kw), want,
        "device table", False))
    check(bool((want[int(padded.sum()):] == 0).all()), "surplus rows not zero")
    print(f"[grouped_gemm fp32/bf16] group sizes [5,0,12,3], [1,1,0,33], "
          f"[0,0,0,17], [40,16,1,0,7], [0,0]; dense E3 C37 D70 F50, E2 C16 "
          f"D64 F128, E5 C1 D300 F7, E4 C130 D33 F200; a worst-case device "
          f"table; tiles {gg.TILES[torch.bfloat16]} (the 128-row one in "
          f"bf16 only), T1 / T2 / T4 / R2 / R4: exact on "
          f"integer values, rel err {worst:.3g} on normal values (rtol "
          f"{ATOL_FP32})")

    # the MoE paths: deepseek-v2-lite's top-6 of 64 experts (D 2048 <->
    # F 1408) and deepseek-v3's top-8 of 256 (D 7168 <-> F 2048), each for
    # a prefill of 8 x 512 tokens and for one decode step of 8; gate / up
    # (D -> F) and down (F -> D), bf16, in the row tile the MoE layer picks
    # (128 rows for the prefill, 16 for the decode step)
    from repro_torch.models import moe
    shapes = []
    for path, e, k, d, f in (("deepseek-v2-lite", 64, 6, 2048, 1408),
                             ("deepseek-v3", 256, 8, 7168, 2048)):
        w_up = expert_weights(gen, e, d, f)
        w_down = expert_weights(gen, e, f, d)
        for phase, tokens in (("prefill", 8 * 512), ("decode", 8)):
            rows, padded, tiles, n_rows = routed_layout(gen, tokens, e, k, d)
            bc = moe.row_tile(tokens * k, e, torch.bfloat16)
            if bc != moe.ROW_TILE:
                tiles = gg.tile_table(padded, bc, -(-n_rows // bc) + e)
            used = int(padded.sum())
            active = int((padded > 0).sum())
            for name, w in (("gate/up", w_up), ("down", w_down)):
                din, dout = w.shape[1], w.shape[2]
                x = torch.zeros(n_rows, din, device="cuda",
                                dtype=torch.bfloat16)
                x[rows] = randn(gen, rows.numel(), din, dtype=torch.bfloat16)
                got = ops.grouped_gemm(x, w, bc=bc, tiles=tiles)
                want = ref.ragged_grouped_gemm(x, w, tiles)
                e_rel, e_abs = rel_err(got, want), err(got, want)
                check(e_rel <= RTOL_GG_BF16,
                      f"grouped_gemm {path} {phase} {name}: rel err {e_rel}")
                nbytes = 2 * (used * din + active * din * dout + used * dout)
                bound, by = bound_ms(nbytes, 2.0 * used * din * dout,
                                     PEAK_FLOPS_BF16)
                ms = timer.ms(lambda: ops.grouped_gemm(x, w, bc=bc,
                                                       tiles=tiles))
                plain = timer.ms(lambda: ref.ragged_grouped_gemm(x, w, tiles),
                                 iters=5)
                lib = None
                if hasattr(torch, "_grouped_mm"):
                    # the yardstick only: the port never calls it
                    offs = torch.cumsum(padded, 0).to(torch.int32)
                    try:
                        lib = timer.ms(lambda: torch._grouped_mm(x, w,
                                                                 offs=offs))
                    except RuntimeError as exc:
                        print(f"[grouped_gemm] torch._grouped_mm refused "
                              f"these inputs: {str(exc).splitlines()[0]}")
                print(f"[grouped_gemm {path} {phase} {name}] {tokens} tokens "
                      f"x top-{k}: {used} padded rows in {active} of {e} "
                      f"experts, {bc}-row tiles, D{din} F{dout} bf16: rel err "
                      f"{e_rel:.3g} (rtol {RTOL_GG_BF16:.3g}), max abs err "
                      f"{e_abs:.3g}; kernel {ms:.4f} ms, plain {plain:.4f} "
                      f"ms, torch._grouped_mm "
                      f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
                      f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)")
                shapes.append({"shape": f"{path} {phase} {name}",
                               "rows": used, "row_tile": bc,
                               "experts": active, "max_abs_err": e_abs,
                               "ms": ms, "plain_ms": plain, "bound_ms": bound,
                               "bound_by": by, "library_ms": lib})
                del x, got, want
        del w_up, w_down
    # the kernels line carries deepseek-v2-lite's decode step's gate / up
    # shape, the one launched most (52 of the 78 launches of each of the 64
    # steps); every shape is under "shapes"
    main = shapes[2]
    return [{"name": "grouped_gemm", "route": "cuda",
             "source": "src/repro_torch/csrc/grouped_gemm.cu",
             "replaces": "src/repro/kernels/grouped_gemm.py:70",
             "max_abs_err": max(s_["max_abs_err"] for s_ in shapes),
             **{k_: main[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
             "shapes": shapes}]


# ------------------------------------ the new configs' kernel shapes --
# the dense and hybrid configs whose attention shapes phase 3 (k) checks:
# (config, q heads, kv heads, head dim) come from each CONFIG
SERVING_ARCHS = ("qwen2-7b", "qwen2.5-14b", "granite-3-2b", "zamba2-2.7b")


def attention_shape(arch: str):
    from repro_torch.configs.base import load_arch
    cfg = load_arch(arch)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_


def flash_at(timer, gen, label, b, h, hkv, s, d, causal=True) -> dict:
    """Flash attention in bf16, causal or not, at one serving shape: every
    built pump case against the plain version under ATOL_BF16 with T1's
    bits; T1, plain and SDPA times beside the bound."""
    from repro_torch.core.pump_plan import PEAK_FLOPS_BF16, bound_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q = randn(gen, b, h, s, d, dtype=torch.bfloat16)
    k = randn(gen, b, hkv, s, d, dtype=torch.bfloat16)
    v = randn(gen, b, hkv, s, d, dtype=torch.bfloat16)
    want = ref.flash_attention(q, k, v, causal=causal)

    def check_one(outs, name):
        e = err(outs[0], want)
        check(e <= ATOL_BF16, f"{name}: err {e} > {ATOL_BF16}")
        return e

    def run(pump):
        return (fa.flash_attention_cuda(q, k, v, causal=causal, pump=pump),)
    built = lambda f, m: fa.built(f, m, d, q.dtype)  # noqa: E731
    cases, e = pump_sweep(f"flash {label}", run, check_one, built)
    pumps = pump_times(timer, f"flash {label}", run, built)
    pairs = sum(min(i + 1, s) for i in range(s)) if causal else s * s
    flops = 4.0 * b * h * d * pairs
    bound, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()), flops,
                         PEAK_FLOPS_BF16)
    ms = timer.ms(lambda: fa.flash_attention_cuda(q, k, v, causal=causal))
    plain = timer.ms(lambda: ref.flash_attention(q, k, v, causal=causal))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True))
    mask = "causal" if causal else "non-causal"
    print(f"[flash {label}] B{b} H{h}/{hkv} S=T={s} D{d} (padded width "
          f"{fa.padded_dim(d)}) bf16 {mask}, {'/'.join(cases)}: max abs err "
          f"{e:.3g} (atol {ATOL_BF16}), identical bits; kernel {ms:.4f} ms "
          f"({flops / ms * 1e-9:.1f} TFLOP/s, {ms / lib:.2f}x SDPA), plain "
          f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"shape": f"{label} B{b} H{h}/{hkv} S{s} D{d}"
            + ("" if causal else " non-causal"), "max_abs_err": e,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib, "pump_ms": pumps}


def decode_at(timer, gen, label, b, h, hkv, t, d, pos) -> dict:
    """Decode attention with a bf16 q and an fp32 cache at one serving
    shape, every row at ``pos`` (an int), or row i at ``pos[i]`` (a
    list, as a stream's lanes): every built pump case against the plain
    version under ATOL_BF16 with T1's bits; T1, plain and SDPA times
    beside the bound."""
    from repro_torch.core.pump_plan import PEAK_FLOPS_FP32, bound_ms
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    q = randn(gen, b, h, d, dtype=torch.bfloat16)
    kc, vc = randn(gen, b, hkv, t, d), randn(gen, b, hkv, t, d)
    rows = [pos] * b if isinstance(pos, int) else list(pos)
    p = torch.tensor(rows, dtype=torch.int32, device="cuda")
    want = ref.decode_attention(q, kc, vc, p)

    def check_one(outs, name):
        e = err(outs[0], want)
        check(e <= ATOL_BF16, f"{name}: err {e} > {ATOL_BF16}")
        return e

    def run(pump):
        return (da.decode_attention_cuda(q, kc, vc, p, pump=pump),)
    built = lambda f, m: da.built(f, m, h // hkv, d, kc.dtype)  # noqa: E731
    cases, e = pump_sweep(f"decode {label}", run, check_one, built)
    check(da.splits(b, hkv, t, d, kc.dtype)
          == da.kernel_splits(b, hkv, t, d, kc.dtype),
          f"decode {label}: the wrapper's and the kernel's splits differ")
    pumps = pump_times(timer, f"decode {label}", run, built)
    n_keys = sum(min(r, t - 1) + 1 for r in rows)
    bound, by = bound_ms(2 * q.numel() * 2 + p.numel() * 4
                         + 2 * n_keys * hkv * d * 4,
                         4.0 * h * d * n_keys, PEAK_FLOPS_FP32)
    ms = timer.ms(lambda: da.decode_attention_cuda(q, kc, vc, p))
    plain = timer.ms(lambda: ref.decode_attention(q, kc, vc, p))
    keep = (torch.arange(t, device="cuda")[None, :] <= p[:, None])
    q4 = q.float()[:, :, None, :]
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=keep[:, None, None, :], enable_gqa=True))
    print(f"[decode {label}] B{b} H{h}/{hkv} (group {h // hkv}, "
          f"{da.lane_slots(h // hkv, d)} of {da.MAX_LANE_SLOTS} lane slots) "
          f"T{t} D{d}, q bf16, cache fp32, pos {pos}, "
          f"{da.splits(b, hkv, t, d, kc.dtype)} splits, {'/'.join(cases)}: "
          f"max abs err {e:.3g} (atol {ATOL_BF16}), identical bits; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
          f"{bound:.4f} ms ({by})")
    return {"shape": f"{label} B{b} H{h}/{hkv} T{t} D{d}", "max_abs_err": e,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib, "pump_ms": pumps}


def scan_bound(b, l, h, g, n, p, chunk, tensors):
    """The SSD scan's bound: each input read once and y and the state
    written once, against the products' bf16 terms on the tensor cores
    (``ssd_scan.TERMS``): the causal half of C·Bᵀ once per (b, group,
    chunk), and per (b, h, chunk) C·S, the causal half of G·x and the
    state update.  Returns (bound ms, by, bytes, bf16-term FLOP)."""
    from repro_torch.core.pump_plan import PEAK_FLOPS_BF16, bound_ms
    from repro_torch.kernels import ssd_scan as ss
    tri = chunk * (chunk + 1) // 2
    per = b * -(-l // chunk) * 2
    prods = {"C.B^T": per * g * tri * n, "C.S": per * h * chunk * p * n,
             "G.x": per * h * tri * p, "state": per * h * n * p * chunk}
    tc_flops = sum(v * ss.TERMS[k] for k, v in prods.items())
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return (*bound_ms(nbytes, tc_flops, PEAK_FLOPS_BF16), nbytes, tc_flops)


def scan_at(timer, gen, label, b, l, h, g, n, p, chunk) -> dict:
    """The SSD scan in bf16 with its final state at one serving shape:
    every built pump case against the plain version (y within
    RTOL_SSD_BF16, the state within RTOL_SSD_FP32) with T1's bits; T1 and
    plain times beside the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    x, dt, a, bm, cm = ssd_inputs(gen, b, l, h, g, n, p, torch.bfloat16)
    y_ref, st_ref = ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                 final_state=True)

    def check_scan(outs, name):
        e_y, e_s = rel_err(outs[0], y_ref), rel_err(outs[1], st_ref)
        check(e_y <= RTOL_SSD_BF16, f"{name}: y rel err {e_y}")
        check(e_s <= RTOL_SSD_FP32, f"{name}: state rel err {e_s}")
        return max(err(outs[0], y_ref), err(outs[1], st_ref))

    def run_scan(pump):
        return ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=chunk,
                                final_state=True, pump=pump)
    cases, e_scan = pump_sweep(f"ssd_scan {label}", run_scan, check_scan,
                               ss.built)
    y, st = run_scan(1)
    pumps = pump_times(timer, f"ssd_scan {label}", run_scan, ss.built)
    bound, by, nbytes, tc_flops = scan_bound(b, l, h, g, n, p, chunk,
                                             (x, dt, a, bm, cm, y, st))
    ms = timer.ms(lambda: ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=chunk,
                                           final_state=True))
    plain = timer.ms(lambda: ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                          final_state=True))
    print(f"[ssd_scan {label}] B{b} L{l} H{h} G{g} N{n} P{p} chunk {chunk} "
          f"bf16, {'/'.join(cases)}: rel err y {rel_err(y, y_ref):.3g} "
          f"(rtol {RTOL_SSD_BF16:.3g}), state {rel_err(st, st_ref):.3g} "
          f"(rtol {RTOL_SSD_FP32}), identical bits; kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e6:.1f} MB, {tc_flops / 1e9:.2f} GFLOP of bf16 "
          f"terms)")
    return {"shape": f"{label} B{b} L{l} H{h} N{n} P{p}",
            "max_abs_err": e_scan, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "pump_ms": pumps}


def phase_serving_shapes(timer, entries) -> None:
    """(k) the shapes the new configs' serving paths give the kernels,
    each against its plain version under the tolerance of the phase that
    checks the kernel at qwen3's and mamba2's shapes, timed beside its
    bound and, where one exists, SDPA: flash (B 8, S 512, bf16, causal)
    and decode attention (B 8, T 577, fp32 cache, pos 575) at the head
    groups and widths of qwen2-7b (7 q heads a kv head, D 128),
    qwen2.5-14b (5, D 128), granite-3-2b (4, D 64) and zamba2-2.7b (1, D
    80, which flash runs in its padded width 128); the SSD scan (B 8, L
    512, H 80, P 64, N 64, chunk 64, bf16: the tensor-core body in its
    generic form, not the constant-width build of N 128) and the SSD
    decode step at zamba2's widths.  Each goes into its kernel entry's
    ``shapes``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_decode as sd
    from repro_torch.core.pump_plan import PEAK_FLOPS_FP32, bound_ms
    by_name = {e_["name"]: e_ for e_ in entries}
    gen = torch.Generator(device="cuda").manual_seed(2222)
    for arch in SERVING_ARCHS:
        h, hkv, d = attention_shape(arch)
        by_name["flash_attention"].setdefault("shapes", []).append(
            flash_at(timer, gen, arch, 8, h, hkv, 512, d))
        by_name["decode_attention"].setdefault("shapes", []).append(
            decode_at(timer, gen, arch, 8, h, hkv, 577, d, 575))

    from repro_torch.configs.base import load_arch
    cfg = load_arch("zamba2-2.7b")
    s_ = cfg.ssm
    b, l, g, n, p, chunk = 8, 512, s_.n_groups, s_.state_dim, s_.head_dim, \
        s_.chunk
    h = s_.expand * cfg.d_model // p
    by_name["ssd_scan"].setdefault("shapes", []).append(
        scan_at(timer, gen, "zamba2-2.7b", b, l, h, g, n, p, chunk))

    x, dt, a, bm, cm = ssd_inputs(gen, b, 1, h, g, n, p, torch.bfloat16)
    x, dt, bm, cm = x[:, 0], dt[:, 0], bm[:, 0], cm[:, 0]
    st = randn(gen, b, h, n, p)
    y, st2 = sd.ssd_decode_cuda(st, x, dt, a, bm, cm)
    y_ref, st2_ref = ref.ssd_decode(st, x, dt, a, bm, cm)
    e_y, e_s = rel_err(y, y_ref), rel_err(st2, st2_ref)
    check(max(e_y, e_s) <= RTOL_SSD_FP32,
          f"ssd_decode zamba2 rel err {max(e_y, e_s)} > {RTOL_SSD_FP32}")
    nbytes = sum(t.numel() * t.element_size() for t in (st, x, dt, a, bm, cm,
                                                         y, st2))
    bound, by = bound_ms(nbytes, 5.0 * b * h * n * p, PEAK_FLOPS_FP32)
    ms = timer.ms(lambda: sd.ssd_decode_cuda(st, x, dt, a, bm, cm))
    plain = timer.ms(lambda: ref.ssd_decode(st, x, dt, a, bm, cm))
    print(f"[ssd_decode zamba2] B{b} H{h} G{g} N{n} P{p}, x / dt / B / C "
          f"bf16, state fp32: rel err y {e_y:.3g}, state {e_s:.3g} (rtol "
          f"{RTOL_SSD_FP32}); kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)")
    by_name["ssd_decode"].setdefault("shapes", []).append(
        {"shape": f"zamba2-2.7b B{b} H{h} N{n} P{p}",
         "max_abs_err": max(err(y, y_ref), err(st2, st2_ref)), "ms": ms,
         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
         "library_ms": None})


def phase_stream_shapes(timer, entries) -> None:
    """(l) the shapes the stream phases give the kernels beyond (b)-(d),
    each against its plain version in every built pump case, timed beside
    its bound: flash at qwen3's heads (16 / 8, D 128) on admission groups
    of 128- and 256-token prompts, padded to the engine batch 8; the SSD
    scan at mamba2's widths (H 64, P 64, N 128, chunk 64) with its final
    state on a 256-token group (B 8) and a continuation chunk on the
    one-lane side cache (B 1); decode attention at qwen3's heads at the
    preempted stream's 4 lanes, each at its own depth
    (``STREAM_B4_POS``).  Each goes into its kernel entry's ``shapes``."""
    from repro_torch.configs.base import load_arch
    by_name = {e_["name"]: e_ for e_ in entries}
    gen = torch.Generator(device="cuda").manual_seed(2323)
    h, hkv, d = attention_shape("qwen3-0.6b")
    for s in (128, 256):
        by_name["flash_attention"].setdefault("shapes", []).append(
            flash_at(timer, gen, "qwen3 stream", 8, h, hkv, s, d))
    by_name["decode_attention"].setdefault("shapes", []).append(
        decode_at(timer, gen, "qwen3 stream", 4, h, hkv, 577, d,
                  STREAM_B4_POS))
    cfg = load_arch("mamba2-1.3b")
    s_ = cfg.ssm
    nh = s_.expand * cfg.d_model // s_.head_dim
    for b in (8, 1):
        by_name["ssd_scan"].setdefault("shapes", []).append(
            scan_at(timer, gen, "mamba2 stream", b, 256, nh, s_.n_groups,
                    s_.state_dim, s_.head_dim, s_.chunk))


def phase_encdec_vlm_shapes(timer, entries) -> None:
    """(m) the shapes whisper-base's and internvl2-2b's paths give the
    kernels, each in every built pump case against its plain version under
    ATOL_BF16 with T1's bits, timed beside its bound and SDPA: flash
    non-causal at the encoder's (B 8, 8 / 8 heads, S = T = 1500, D 64; the
    last 64-key tile holds 28 keys), causal at whisper's prefill (S 384,
    D 64) and at internvl2's image-prefixed forward (16 / 8 heads, S 768 =
    256 patches + 512 tokens, D 128); decode attention at whisper's decode
    (B 8, 8 / 8 heads, group 1, T 448, D 64, fp32 cache) at pos 384 and at
    ``WHISPER_ROW_POS``.  Each goes into its kernel entry's ``shapes``."""
    from repro_torch.configs.base import load_arch
    by_name = {e_["name"]: e_ for e_ in entries}
    gen = torch.Generator(device="cuda").manual_seed(2424)
    flash = by_name["flash_attention"].setdefault("shapes", [])
    decode = by_name["decode_attention"].setdefault("shapes", [])
    h, hkv, d = attention_shape("whisper-base")
    enc = load_arch("whisper-base").encoder_seq
    flash.append(flash_at(timer, gen, "whisper-base encoder", 8, h, hkv, enc,
                          d, causal=False))
    flash.append(flash_at(timer, gen, "whisper-base prefill", 8, h, hkv,
                          WHISPER_PROMPT, d))
    for label, pos in (("whisper-base", WHISPER_PROMPT),
                       ("whisper-base per-row", WHISPER_ROW_POS)):
        decode.append(decode_at(timer, gen, label, 8, h, hkv,
                                WHISPER_MAX_LEN, d, pos))
    vlm = load_arch("internvl2-2b")
    h, hkv, d = attention_shape("internvl2-2b")
    flash.append(flash_at(timer, gen, "internvl2-2b image-prefixed", 8, h,
                          hkv, vlm.n_vision_tokens + 512, d))


# ------------------------------------------------------------ the compiler --
def compiler_cases():
    """The nine builders at ``tests/differential.py``'s first shapes, and a
    second ragged grouped GEMM with an empty expert: (label, builder,
    args, kwargs, input shapes, outputs, exact, transform, expected tier:
    a name, or for the carry builders a function of (M, mode) that says
    ``hopper`` where the kernel is built for the case).  Inputs are
    integer-valued fp32 made from a seed."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    def tier(built):
        return lambda m, mode: "hopper" if built(m, mode) else "carryloop"

    def ssd(d):   # dt > 0, a < 0, on a coarse grid (exact sums)
        d["dt"] = np.abs(d["dt"]) * 0.25 + 0.25
        d["a"] = -(np.abs(d["a"]) * 0.25 + 0.25)
        return d

    def pos(d):
        d["pos"] = np.asarray([17, 31], np.int32)
        return d

    ssd_in = {"x": (1, 32, 2, 4), "dt": (1, 32, 2), "a": (2,),
              "bmat": (1, 32, 2, 4), "cmat": (1, 32, 2, 4)}
    return [
        ("vecadd", "vecadd", (64,), dict(vector_width=8),
         {"x": (64,), "y": (64,)}, ("z",), True, None, "hopper"),
        ("matmul", "matmul", (32, 32, 32),
         dict(bm=16, bn=16, bk=16, vector_width=8),
         {"a": (32, 32), "b": (32, 32)}, ("c",), True, None, "hopper"),
        ("stencil", "stencil", (10, 8, 8), {}, {"x": (10, 8, 8)}, ("y",),
         True, None, "blockloop"),
        ("floyd_warshall", "floyd_warshall", (16,), {},
         {"dist": (16, 16)}, ("out",), True, None, "gather"),
        ("flash_attention", "flash_attention", (1, 2, 32, 32, 8),
         dict(bq=16, bkv=8, causal=True, vector_width=8),
         {"q": (1, 2, 32, 8), "k": (1, 2, 32, 8), "v": (1, 2, 32, 8)},
         ("o", "m", "l"), False, None,
         tier(lambda m, mode: fa.built(m, mode, 8, torch.float32))),
        ("ssd_scan", "ssd_scan", (1, 32, 2, 4, 4),
         dict(chunk=8, vector_width=8), ssd_in, ("y",), False, ssd,
         tier(ss.built)),
        ("grouped_gemm", "grouped_gemm", (2, 32, 16, 8),
         dict(bc=8, bf=8, bd=8, vector_width=8),
         {"x": (2, 32, 16), "w": (2, 16, 8)}, ("o",), True, None, "hopper"),
        ("grouped_gemm ragged", "grouped_gemm", (2, 32, 16, 8),
         dict(bc=8, bf=8, bd=8, group_sizes=(16, 24), vector_width=8),
         {"x": (40, 16), "w": (2, 16, 8)}, ("o",), True, None, "hopper"),
        ("grouped_gemm ragged, empty expert", "grouped_gemm", (3, 16, 8, 8),
         dict(bc=8, bf=8, bd=8, group_sizes=(8, 0, 24), vector_width=8),
         {"x": (32, 8), "w": (3, 8, 8)}, ("o",), True, None, "hopper"),
        ("decode_attention", "decode_attention", (2, 4, 32, 8),
         dict(bkv=8, hkv=2, vector_width=4),
         {"q": (2, 4, 8), "k": (2, 2, 32, 8), "v": (2, 2, 32, 8),
          "pos": (2,)}, ("o",), False, pos,
         tier(lambda m, mode: da.built(m, mode, 2, 8, torch.float32))),
        ("ssd_scan final state", "ssd_scan", (1, 32, 2, 4, 4),
         dict(chunk=8, vector_width=8, final_state=True), ssd_in,
         ("y", "state"), False, ssd, tier(ss.built)),
        ("ssd_decode", "ssd_decode", (2, 4, 8, 4),
         dict(n_groups=2, vector_width=4),
         {"state": (2, 4, 4, 8), "x": (2, 4, 8), "dt": (2, 4), "a": (4,),
          "bmat": (2, 2, 4), "cmat": (2, 2, 4)}, ("y", "state_out"), False,
         ssd, "hopper"),
    ]


def first_plan(kern):
    """The plan of a compiled graph's first region."""
    from repro_torch.compiler import hopper_backend as hb
    g = kern.graph
    return hb.plan_region(g, hb.partition_regions(g)[0], lambda _m: None)


def first_desc(kern):
    """The region kernel's descriptor of a hopper compile's first region."""
    return kern.fn.regions[0][2].desc


def phase_compiler(timer):
    """(j) the compiler, ``compile(backend='hopper')`` and its region
    kernel: (a) the builders at small shapes against the port's executor,
    with each region's tier; (b) the region kernel against its plain
    version on small ragged descriptors; (c) card sizes, the launches of
    that run counted, against the direct kernels and the plain versions;
    (d) ``autotune='measure'`` and its replay.  Returns (kernels entries,
    launches of the card-size run)."""
    from repro_torch import compiler
    from repro_torch.compiler import hopper_backend as hb
    from repro_torch.core import executor
    from repro_torch.core.autopump import BUILDERS
    from repro_torch.core.pump_plan import (PEAK_FLOPS_BF16, PEAK_FLOPS_FP32,
                                            PEAK_OPS_FP32, bound_ms)
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import region_map_reduce as rmr
    from repro_torch.kernels import ssd_decode as sd
    from repro_torch.kernels import vecadd as va
    from repro_torch.launch import paper
    gen = torch.Generator(device="cuda").manual_seed(99)
    t0 = time.perf_counter()

    # (a) every builder through both executable backends on CUDA tensors
    worst, tiers = {}, {}
    for label, kern_name, args, kw, shapes, outs, exact, tf, tier in \
            compiler_cases():
        rng = np.random.default_rng(0)
        data = {k: rng.integers(-3, 4, s).astype(np.float32)
                for k, s in shapes.items()}
        if tf is not None:
            data = tf(data)
        cuda_in = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
        for backend in ("hopper", "torch"):
            for m in (1, 2, 4):
                for mode in ("T", "R"):
                    g, _ = BUILDERS[kern_name](*args, **kw)
                    k = compiler.compile(g, factor=m, mode=mode,
                                         backend=backend, cache=False,
                                         memoize=False)
                    got = k(cuda_in)
                    gold = executor.run(k.graph, dict(data))
                    for o in outs:
                        a = got[o].float().cpu().numpy()
                        e = float(np.abs(a - gold[o]).max())
                        worst[label] = max(worst.get(label, 0.0), e)
                        ok = e == 0 if exact else np.allclose(
                            a, gold[o], rtol=ATOL_EXP, atol=ATOL_EXP)
                        check(ok, f"compile {label} {backend} M{m} {mode} "
                                  f"{o}: max abs err {e}")
                    if backend == "hopper":
                        em = list(k.report.emission.values())
                        want = tier(m, mode) if callable(tier) else tier
                        check(len(em) == 1 and em[0]["tier"] == want,
                              f"compile {label} M{m} {mode}: tier "
                              f"{[x['tier'] for x in em]} != {want} "
                              f"({[x['why'] for x in em]})")
                        tiers.setdefault(label, set()).add(
                            f"{m}{mode}:{em[0]['tier']}")
    print(f"[compiler] (a) {len(worst)} builder cases x M 1/2/4 x T/R x "
          f"hopper/torch on CUDA tensors vs the executor, tiers as "
          f"expected: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (exact, or rtol=atol {ATOL_EXP} where exp enters)")
    for label in ("flash_attention", "decode_attention", "ssd_scan",
                  "ssd_scan final state"):
        print(f"[compiler] (a) {label} tiers: "
              + " ".join(sorted(tiers[label])))

    # (b) the region kernel against its plain version on small ragged
    # descriptors: add and dot, fp32 and bf16, M 1/2/4/8 x T/R, an empty
    # group; integer values exact, normal bf16 values under RTOL_REGION_BF16
    desc_cases = [
        ("vecadd V8", "vecadd", (8 * 1000,), dict(vector_width=8)),
        ("vecadd V4", "vecadd", (4 * 1000,), dict(vector_width=4)),
        ("matmul", "matmul", (48, 80, 128),
         dict(bm=16, bn=16, bk=16, vector_width=8)),
        ("dense grouped", "grouped_gemm", (3, 32, 128, 24),
         dict(bc=16, bf=8, bd=16, vector_width=8)),
        ("ragged grouped", "grouped_gemm", (4, 16, 64, 16),
         dict(bc=8, bf=16, bd=8, group_sizes=(16, 0, 40, 8),
              vector_width=8)),
    ]
    n_desc, n_mma, worst_bf16 = 0, 0, 0.0
    for label, kern_name, args, kw in desc_cases:
        for m in (1, 2, 4, 8):
            for mode in ("T", "R"):
                g, _ = BUILDERS[kern_name](*args, **kw)
                k = compiler.compile(g, factor=m, mode=mode, backend="none",
                                     cache=False, memoize=False)
                plan = first_plan(k)
                check(plan.pallas_ok, f"{label} M{m} {mode}: not block-unit")
                for dtype in ("float32", "bfloat16"):
                    desc, why = hb.region_descriptor(k.graph, plan, dtype)
                    check(desc is not None, f"{label} M{m} {mode}: {why}")
                    n_mma += 2 * rmr.mma_path(desc)
                    tdt = getattr(torch, dtype)
                    for kind in ("ints", "normal"):
                        ins = [(torch.randint(-4, 5, o.shape, generator=gen,
                                              device="cuda")
                                if kind == "ints" else
                                torch.randn(o.shape, generator=gen,
                                            device="cuda")).to(tdt)
                               for o in desc.ins]
                        got = rmr.region_map_reduce_cuda(desc, ins)
                        want = ref.region_map_reduce(desc, ins)
                        if kind == "ints":
                            e = err(got, want)
                            check(e == 0, f"region {label} M{m} {mode} "
                                          f"{dtype} ints: err {e}")
                        else:
                            e = rel_err(got, want)
                            tol = RTOL_REGION_BF16 if dtype == "bfloat16" \
                                else ATOL_FP32
                            worst_bf16 = max(worst_bf16, e)
                            check(e <= tol, f"region {label} M{m} {mode} "
                                            f"{dtype} normal: rel err {e}")
                        n_desc += 1
    check(n_mma > 0, "no bf16 dot took the tensor-core path")
    print(f"[compiler] (b) region kernel vs plain: {n_desc} runs (vecadd V8 "
          f"/ V4, matmul 48x80x128, dense and ragged grouped GEMM with an "
          f"empty group; M 1/2/4/8 x T/R; fp32 and bf16; {n_mma} of them "
          f"bf16 dots on the tensor cores): exact on integer values, normal "
          f"values rel err {worst_bf16:.3g} (rtol {ATOL_FP32} fp32, "
          f"{RTOL_REGION_BF16:.3g} bf16)")

    # (c) card sizes through compile(backend='hopper'): the main path of
    # this phase, its launches counted around the four runs
    n = paper.CARD["vecadd_n"]
    size = paper.CARD["mm"]
    rows, padded, _tiles, _n_rows = routed_layout(gen, 8 * 512)
    sizes = [int(s_) for s_ in padded.tolist()]
    used = sum(sizes)
    e_, d_, f_ = 64, 2048, 1408
    card = [
        ("vecadd", (n,), dict(vector_width=8)),
        ("matmul", (size, size, size), dict(bm=128, bn=128, bk=128)),
        ("grouped_gemm", (e_, 512, d_, f_),
         dict(bc=16, bf=128, bd=32, itemsize=2, dtype="bfloat16",
              group_sizes=sizes)),
        ("ssd_decode", (8, 64, 64, 128), dict(n_groups=1)),
    ]
    x_va, y_va = randn(gen, n), randn(gen, n)
    a_mm, b_mm = randn(gen, size, size), randn(gen, size, size)
    x_gg = randn(gen, used, d_, dtype=torch.bfloat16)
    w_gg = (randn(gen, e_, d_, f_) / d_ ** 0.5).to(torch.bfloat16)
    sx, sdt, sa, sbm, scm = ssd_inputs(gen, 8, 1, 64, 1, 128, 64)
    sx, sdt, sbm, scm = (t[:, 0].contiguous() for t in (sx, sdt, sbm, scm))
    sst = randn(gen, 8, 64, 128, 64)
    card_in = [{"x": x_va, "y": y_va}, {"a": a_mm, "b": b_mm},
               {"x": x_gg, "w": w_gg},
               {"state": sst, "x": sx, "dt": sdt, "a": sa, "bmat": sbm,
                "cmat": scm}]
    kerns = []
    for name, args, kw in card:
        g, est = BUILDERS[name](*args, **kw)
        kerns.append(compiler.compile(g, factor=1, estimate=est,
                                      backend="hopper", cache=False,
                                      memoize=False))
        em = list(kerns[-1].report.emission.values())[0]
        check(em["tier"] == "hopper", f"{name} card size: tier {em}")
    torch.cuda.synchronize()
    rmr.launches = sd.launches = 0
    outs = [k(inp) for k, inp in zip(kerns, card_in)]
    torch.cuda.synchronize()
    launches = {"region_map_reduce": rmr.launches}
    check(rmr.launches == 3 and sd.launches == 1,
          f"card-size compiles launched region_map_reduce {rmr.launches} "
          f"and ssd_decode {sd.launches} times (want 3 and 1)")
    print(f"[compiler] (c) card sizes through compile(backend='hopper'): "
          f"launches region_map_reduce {rmr.launches}, ssd_decode "
          f"{sd.launches}")

    shapes = []
    # vecadd
    desc = first_desc(kerns[0])
    z = outs[0]["z"]
    e_z = max(err(z, va.vecadd_cuda(x_va, y_va, vector_width=8)),
              err(z, ref.vecadd(x_va, y_va)))
    check(e_z == 0, f"vecadd card size: max abs err {e_z}")
    bound, by = bound_ms(3 * n * 4, n, PEAK_OPS_FP32)
    shapes.append(("vecadd 2^28 fp32 V8", desc, [x_va, y_va], e_z,
                   lambda: va.vecadd_cuda(x_va, y_va, vector_width=8),
                   lambda: torch.add(x_va, y_va), bound, by))
    # matmul
    desc = first_desc(kerns[1])
    c = outs[1]["c"]
    want = ref.matmul(a_mm, b_mm)
    e_c = rel_err(c, want)
    e_d = rel_err(c, mm.matmul_cuda(a_mm, b_mm))
    check(max(e_c, e_d) <= paper.RTOL_MATMUL,
          f"matmul card size: rel err {e_c} (plain), {e_d} (direct)")
    bound, by = bound_ms(3 * size * size * 4, 2.0 * size ** 3,
                         PEAK_FLOPS_FP32)
    shapes.append((f"matmul {size}^3 fp32, 128^3 blocks", desc, [a_mm, b_mm],
                   err(c, want), lambda: mm.matmul_cuda(a_mm, b_mm),
                   lambda: torch.matmul(a_mm, b_mm), bound, by))
    # the ragged grouped GEMM at the deepseek prefill's routing, a bf16 dot
    # on the tensor cores
    desc = first_desc(kerns[2])
    check(rmr.mma_path(desc), "the card-size ragged GEMM is not on the "
                              "tensor-core path")
    o = outs[2]["o"]
    want = ops.grouped_gemm(x_gg, w_gg, group_sizes=sizes, bc=16, bf=128,
                            bd=32)
    plain = ref.ragged_grouped_gemm(
        x_gg, w_gg, gg.tile_table(padded, 16, used // 16))
    e_o = max(rel_err(o, want), rel_err(o, plain))
    check(e_o <= RTOL_GG_BF16, f"grouped GEMM card size: rel err {e_o}")
    active = sum(1 for s_ in sizes if s_)
    bound, by = bound_ms(2 * (used * d_ + active * d_ * f_ + used * f_),
                         2.0 * used * d_ * f_, PEAK_FLOPS_BF16)
    offs = torch.cumsum(padded, 0).to(torch.int32)
    lib = (lambda: torch._grouped_mm(x_gg, w_gg, offs=offs)) \
        if hasattr(torch, "_grouped_mm") else None
    shapes.append((f"ragged grouped GEMM {used} rows (8 x 512 tokens, top-6 "
                   f"of 64) x {d_} -> {f_} bf16", desc, [x_gg, w_gg],
                   err(o, plain),
                   lambda: ops.grouped_gemm(x_gg, w_gg, group_sizes=sizes,
                                            bc=16, bf=128, bd=32),
                   lib, bound, by))
    # ssd_decode through its binding
    y_c, s_c = outs[3]["y"], outs[3]["state_out"]
    y_d, s_d = sd.ssd_decode_cuda(sst, sx, sdt, sa, sbm, scm)
    y_p, s_p = ref.ssd_decode(sst, sx, sdt, sa, sbm, scm)
    e_sd = max(rel_err(y_c, y_p), rel_err(s_c, s_p))
    check(e_sd <= RTOL_SSD_FP32 and err(y_c, y_d) == 0
          and err(s_c, s_d) == 0,
          f"ssd_decode card size: rel err {e_sd}, vs direct "
          f"{err(y_c, y_d)} / {err(s_c, s_d)}")
    nbytes = sum(t.numel() * t.element_size()
                 for t in (sst, sx, sdt, sa, sbm, scm, y_d, s_d))
    sd_bound, sd_by = bound_ms(nbytes, 5.0 * 8 * 64 * 128 * 64,
                               PEAK_FLOPS_FP32)
    k_sd, in_sd = kerns[3], card_in[3]
    sd_ms = timer.ms(lambda: k_sd(in_sd))
    sd_direct = timer.ms(lambda: sd.ssd_decode_cuda(sst, sx, sdt, sa, sbm,
                                                    scm))
    sd_plain = timer.ms(lambda: ref.ssd_decode(sst, sx, sdt, sa, sbm, scm))
    print(f"[compiler] ssd_decode B8 H64 P64 N128 through its binding: "
          f"compiled {sd_ms:.4f} ms, direct kernel {sd_direct:.4f} ms, plain "
          f"{sd_plain:.4f} ms, bound {sd_bound:.4f} ms ({sd_by}); rel err "
          f"{e_sd:.3g}, identical to the direct kernel")

    entries = []
    for label, desc, ins, e_abs, direct, lib, bound, by in shapes:
        ms = timer.ms(lambda: rmr.region_map_reduce_cuda(desc, ins))
        d_ms = timer.ms(direct)
        p_ms = timer.ms(lambda: ref.region_map_reduce(desc, ins), iters=3)
        l_ms = None
        if lib is not None:
            try:
                l_ms = timer.ms(lib)
            except RuntimeError as exc:
                print(f"[compiler] library call refused: "
                      f"{str(exc).splitlines()[0]}")
        print(f"[compiler] {label}: region kernel {ms:.4f} ms, direct kernel "
              f"{d_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
              f"{bound:.4f} ms ({by}); max abs err {e_abs:.3g}")
        entries.append({"shape": label, "max_abs_err": e_abs, "ms": ms,
                        "direct_ms": d_ms, "plain_ms": p_ms,
                        "bound_ms": bound, "bound_by": by,
                        "library_ms": l_ms})

    # (d) autotune='measure' at card size, then its replay from the cache
    path = BUILD_CACHE / "compile_cache.json"
    path.unlink(missing_ok=True)
    for (name, args, kw), inp in zip(card, card_in):
        g, est = BUILDERS[name](*args, **kw)
        k1 = compiler.compile(g, factor="auto", estimate=est,
                              backend="hopper", autotune="measure",
                              cache=compiler.CompileCache(path))
        at = k1.report.autotune
        check(k1.report.measurements > 0 and not at["replayed"],
              f"{name}: measure did not measure")
        compiler.clear_memo()
        g2, _ = BUILDERS[name](*args, **kw)
        k2 = compiler.compile(g2, factor="auto", estimate=est,
                              backend="hopper", autotune="measure",
                              cache=compiler.CompileCache(path))
        check(k2.report.served_from == "disk"
              and k2.report.measurements == 0
              and k2.report.autotune["replayed"]
              and k2.spec.factor == k1.spec.factor,
              f"{name}: the replay measured again or changed the factor")
        out = k2(inp)
        check(all(bool(torch.isfinite(v.float()).all())
                  for v in out.values()), f"{name}: replay not finite")
        print(f"[compiler] (d) {name}: measured factor {at['winner']} "
              f"(µs per candidate {at['timings_us']}); replayed from the "
              f"cache with 0 measurements, factor {k2.spec.factor}")
    # pump='measure' on the three carry ops: the compiled carry graph times
    # the CUDA kernels (their launch counts move), and the winner drives the
    # direct kernel, against the plain version
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    q = randn(gen, 2, 8, 256, 64)
    k, v = randn(gen, 2, 4, 256, 64), randn(gen, 2, 4, 256, 64)
    qd, kc, vc = randn(gen, 4, 8, 128), randn(gen, 4, 4, 512, 128), \
        randn(gen, 4, 4, 512, 128)
    pos = torch.tensor([511, 300, 0, 128], dtype=torch.int32, device="cuda")
    sx, sdt, sa, sbm, scm = ssd_inputs(gen, 2, 256, 8, 1, 128, 64)
    for name, mod, run, plain in (
            ("flash_attention", fa,
             lambda pump: ops.flash_attention(q, k, v, causal=True,
                                              pump=pump),
             lambda: ref.flash_attention(q, k, v, causal=True)),
            ("decode_attention", da,
             lambda pump: ops.decode_attention(qd, kc, vc, pos, pump=pump),
             lambda: ref.decode_attention(qd, kc, vc, pos)),
            ("ssd_scan", ss,
             lambda pump: ops.ssd_scan(sx, sdt, sa, sbm, scm, chunk=64,
                                       pump=pump),
             lambda: ref.ssd_scan(sx, sdt, sa, sbm, scm, chunk=64))):
        mod.launches = 0
        got = run("measure")
        torch.cuda.synchronize()
        n = mod.launches
        e = rel_err(got, plain())
        check(n > 1 and e <= ATOL_FP32,
              f"{name} pump='measure': {n} launches, rel err {e}")
        print(f"[compiler] (d) {name} pump='measure': {n} kernel launches "
              f"(the measured carry graph and the direct call), rel err "
              f"{e:.3g}")
    print(f"[compiler] phase done in {time.perf_counter() - t0:.1f}s")

    main = entries[1]
    return [{"name": "region_map_reduce", "route": "cuda",
             "source": "src/repro_torch/csrc/region_map_reduce.cu",
             "replaces": "src/repro/compiler/pallas_backend.py:847",
             "max_abs_err": max(s_["max_abs_err"] for s_ in entries),
             **{k_: main[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
             "shapes": entries}], launches


def phase_paper():
    """The paper-table path: ``launch.paper --mode all`` at the card sizes,
    in this process; every row is held to its plain version inside the
    launcher.  Returns the launches of that run."""
    import importlib
    from repro_torch.launch import paper
    names = ("vecadd", "matmul", "stencil", "floyd_warshall")
    mods = {n: importlib.import_module(f"repro_torch.kernels.{n}")
            for n in names}
    t0 = time.perf_counter()
    for mod in mods.values():
        mod.launches = 0
    rows = paper.main(["--mode", "all"])
    launches = {n: mod.launches for n, mod in mods.items()}
    print(f"[paper] {len(rows)} rows in {time.perf_counter() - t0:.1f}s; "
          f"launches: {launches}")
    check(len(rows) == 6 + 3 + 8 + 3 * len(paper.CARD["fw"]),
          f"paper rows {len(rows)}")
    check(all(r.us > 0 for r in rows if not r.name.endswith("_speedup")),
          "a paper row was not timed")
    for n in names:
        check(launches[n] > 0, f"{n} was not launched on the paper path")
    return launches


def plain_moe(cfg):
    """The ragged variant's plain route: the dense dropless einsum path,
    the reference's own direct reference for MoE
    (``benchmarks/serve_report.py:152``)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ragged_dropless=False, inference_capacity_factor=0.0))


def set_field(**fields):
    return lambda cfg: dataclasses.replace(cfg, **fields)


def dsv3_cut(cfg):
    """deepseek-v3's kernel route on the card: every width kept, the depth
    cut to ``DSV3_LAYERS``, its MoE layers ragged dropless."""
    from repro_torch.launch.serve import moe_ragged
    return moe_ragged(dataclasses.replace(cfg, n_layers=DSV3_LAYERS))


def check_moe_layer(cfg_k, cfg_p, model, prompts):
    """One MoE layer on the same input through both routes: the hidden
    states of the prompts after the dense block, through ``blocks[0]``'s
    MoE at the prefill's shape and at one decode step's.  The routing is the
    same (one router, one input), so only the expert products' summation
    order and their bf16 roundings differ."""
    from repro_torch.models import moe
    layer = model.blocks[0]
    with torch.no_grad():
        for name, xin in zip(("prefill", "decode"),
                             moe_layer_input(cfg_k, model, prompts)):
            y_k, aux_k = moe.moe_apply(layer.moe, cfg_k, xin, dropless=True)
            y_p, aux_p = moe.moe_apply(layer.moe, cfg_p, xin, dropless=True)
            e = rel_err(y_k, y_p)
            print(f"[e2e] one MoE layer, kernel vs plain route, {name} "
                  f"{tuple(xin.shape)}: rel err {e:.3g} (rtol "
                  f"{RTOL_MOE_LAYER:.3g}), aux {aux_k.item():.6g} / "
                  f"{aux_p.item():.6g}")
            check(e <= RTOL_MOE_LAYER, f"MoE layer {name}: rel err {e}")
            check(aux_k.item() == aux_p.item(), "aux losses differ")


def moe_layer_input(cfg, model, prompts):
    """The hidden states of the prompts after the dense block, normed for
    ``blocks[0]``'s MoE: (prefill input, one decode step's input)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed, rmsnorm
    with torch.no_grad():
        x = embed(model.embed, prompts.cuda(), cfg.activation_dtype)
        pos = torch.arange(x.shape[1], device="cuda")
        for block in model.blocks_dense:
            x = transformer.dense_block_apply(block, cfg, x, pos)[0]
        x = rmsnorm(model.blocks[0].norm2, x, cfg.norm_eps)
    return x, x[:, -1:]


def ragged_product_times(name, reg, a, w, kw):
    """One expert product (the gate's) on the registry's padded layout,
    CUDA-event times: the compiled ragged graph at the registry's plan (its
    ``ragged_pump``, 1), the same graph at the capacity model's pump
    (``'auto'``, the reference's default), and ``csrc/grouped_gemm.cu`` on
    the same rows in 16-row tiles."""
    from repro_torch.compiler.registry import PlanRegistry
    from repro_torch.kernels import ops
    from repro_torch.launch.timing import Timer
    timer = Timer()
    auto_reg = PlanRegistry(ragged_pump="auto", cache=False)
    t_plan = timer.ms(lambda: reg.grouped_gemm(a, w, **kw))
    t_auto = timer.ms(lambda: auto_reg.grouped_gemm(a, w, **kw))
    (auto_plan,) = auto_reg.plans()
    refused = " (refused: fell back to grouped_gemm.cu)" \
        if auto_reg.stats.fallbacks else ""
    t_gg = timer.ms(lambda: ops.grouped_gemm(
        a, w, group_sizes=kw["group_sizes"], bc=16))
    (plan,) = [pl for pl in reg.plans()
               if pl["args"] == [w.shape[0], a.shape[0], w.shape[1],
                                 w.shape[2]]]
    print(f"[registry] {name} gate product, {a.shape[0]} padded rows x "
          f"{w.shape[1]} -> {w.shape[2]}: region kernel at the plan's "
          f"{plan['launch']} {t_plan:.4f} ms, at the capacity model's "
          f"{auto_plan['launch']} {t_auto:.4f} ms{refused}; "
          f"grouped_gemm.cu on the same rows {t_gg:.4f} ms")


def check_moe_registry(cfg, model, prompts):
    """One MoE layer through the plan registry's ragged route
    (``kernel_plan='measure'``: group sizes on the host, bucketed, the
    compiled ragged graph on the region kernel) against the direct
    ``csrc/grouped_gemm.cu`` route, at the prefill's routing and at one
    decode step's, under ``RTOL_MOE_LAYER``; no ragged plan may be
    measured and none may fall back.  Both routes timed (host clock around
    a synchronized call, median of 5, after one call), and the registry
    route's first call of the routing (cold: a new group-sizes key, so
    two plans compiled and spot-checked, as every fresh routing of real
    traffic pays) beside them."""
    from repro_torch.compiler import CompileCache
    from repro_torch.compiler.registry import (PlanRegistry,
                                               set_default_registry)
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import region_map_reduce as rmr
    from repro_torch.models import moe
    cfg_r = dataclasses.replace(cfg, kernel_plan="measure")
    reg = PlanRegistry(cache=CompileCache(REGISTRY_CACHE))
    old = set_default_registry(reg)
    layer = model.blocks[0].moe

    def wall_ms(fn):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    try:
        with torch.no_grad():
            for name, xin in zip(("prefill", "decode"),
                                 moe_layer_input(cfg, model, prompts)):
                # the first call plans this routing (a miss, its spot
                # check launching each new plan once); the second is warm.
                # The first call's gate product is kept for the timing of
                # one product below
                products = []
                reg.grouped_gemm = lambda a, w, _f=reg.grouped_gemm, **kw: \
                    products.append((a, w, kw)) or _f(a, w, **kw)
                misses = reg.stats.misses
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y_r, _ = moe.moe_apply(layer, cfg_r, xin, dropless=True)
                torch.cuda.synchronize()
                ms_cold = (time.perf_counter() - t0) * 1e3
                del reg.grouped_gemm
                # gate and up share one plan key, down has its own
                check(reg.stats.misses - misses == 2,
                      f"registry MoE layer {name}: the first call made "
                      f"{reg.stats.misses - misses} misses (want 2)")
                ragged_product_times(name, reg, *products[0])
                rmr.launches = gg.launches = 0
                y_r2, _ = moe.moe_apply(layer, cfg_r, xin, dropless=True)
                torch.cuda.synchronize()
                n_rmr, n_gg = rmr.launches, gg.launches
                check(n_rmr == 3 and n_gg == 0 and same_bits(
                    y_r.float(), y_r2.float()),
                      f"registry MoE layer {name}: region_map_reduce "
                      f"{n_rmr}, grouped_gemm {n_gg} launches (want 3, 0)")
                y_d, _ = moe.moe_apply(layer, cfg, xin, dropless=True)
                e = rel_err(y_r, y_d)
                ms_r = wall_ms(lambda: moe.moe_apply(layer, cfg_r, xin,
                                                     dropless=True))
                ms_d = wall_ms(lambda: moe.moe_apply(layer, cfg, xin,
                                                     dropless=True))
                print(f"[registry] one MoE layer, registry ragged route vs "
                      f"direct grouped_gemm.cu route, {name} "
                      f"{tuple(xin.shape)}: rel err {e:.3g} (rtol "
                      f"{RTOL_MOE_LAYER:.3g}); {ms_r:.3f} ms vs {ms_d:.3f} "
                      f"ms a layer warm; the registry route's first call of "
                      f"this routing (2 plans compiled and spot-checked) "
                      f"{ms_cold:.3f} ms")
                check(e <= RTOL_MOE_LAYER,
                      f"registry MoE layer {name}: rel err {e}")
        plans = reg.plans()
        for pl in plans:
            print(f"[registry] ragged plan: {pl['args']} (E, rows, D, F), "
                  f"factor {pl['factor']}{pl['mode']}, launch "
                  f"{pl['launch']}, pump {pl['pump']}, measured "
                  f"{pl['measured']}")
        check(plans and not any(pl["measured"] for pl in plans)
              and reg.stats.measure_s == 0.0,
              "a ragged plan was measured on the hot path")
        check(reg.stats.fallbacks == 0,
              f"registry MoE layer: {reg.stats.fallbacks} fallbacks")
    finally:
        set_default_registry(old)


def phase_e2e(arch: str, kernel_route, plain_route, per_prefill: dict,
              per_step: dict, atol: float, *, hold_prompt: int = 0,
              moe_registry: bool = True, profile: bool = False):
    """One model at full width through Engine.generate, batch 8, prompt
    512, 64 new tokens, on seeded random bf16 weights.  ``kernel_route``
    and ``plain_route`` are (name, config transform) pairs.  Each kernel
    of ``per_prefill`` / ``per_step`` must launch that many times in the
    prefill / in each decode step; the kernel route's logits must stay
    within ``atol`` of the plain route's at every step.  With
    ``hold_prompt`` the plain route runs, and the logits (and an MoE
    layer) are held, at that prompt length instead (the first tokens of the
    same prompts, 64 new tokens), where the plain route fits the card
    beside the weights; the kernel route's launches and times stay at 512.
    ``moe_registry`` runs an MoE model's layer through the plan registry's
    ragged route too; ``profile`` runs ``launch.profile`` on the kernel
    route's config and weights.  Returns the launches of the kernel
    route's run and the context the registry phase serves the same model
    from (config, weights, prompts, the kernel route's tokens, logits and
    times)."""
    import gc
    import importlib
    from repro_torch.configs.base import load_arch
    from repro_torch.models import convert
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import Engine, ServeConfig
    names = sorted(set(per_prefill) | set(per_step))
    mods = {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in names}

    batch, prompt_len, n_new = 8, 512, 64
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (k_name, k_cfg), (p_name, p_cfg) = kernel_route, plain_route
    cfg = k_cfg(load_arch(arch))
    t0 = time.perf_counter()
    model = convert.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if cfg.ssm:
        mixer = (f"SSD {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} "
                 f"heads x {cfg.ssm.head_dim}, state {cfg.ssm.state_dim}, "
                 f"chunk {cfg.ssm.chunk}")
        if cfg.hybrid_attn_every:
            mixer += (f"; one shared attention block ({cfg.n_heads}/"
                      f"{cfg.n_kv_heads} heads x {cfg.head_dim_}, d_ff "
                      f"{cfg.d_ff}) after every {cfg.hybrid_attn_every} "
                      f"layers")
    elif cfg.mla:
        m = cfg.mla
        mixer = (f"MLA {cfg.n_heads} heads, q_lora {m.q_lora_rank}, kv_lora "
                 f"{m.kv_lora_rank}, nope {m.nope_head_dim} + rope "
                 f"{m.rope_head_dim}, v {m.v_head_dim}")
    else:
        mixer = f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim_}"
    if cfg.moe:
        mo = cfg.moe
        mixer += (f"; {mo.n_dense_layers} dense layer(s) then MoE "
                  f"{mo.n_experts} experts top-{mo.top_k} x {mo.d_expert}, "
                  f"{mo.n_shared_experts} shared")
    if cfg.mtp_depth:
        mixer += "; the MTP block carried (no serving path reads it)"
    print(f"[e2e] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{mixer}, vocab {cfg.vocab_size}; {n_params / 1e9:.2f} B seeded "
          f"bf16 weights ({n_params * 2 / 1e9:.1f} GB) in "
          f"{time.perf_counter() - t0:.2f}s")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    scfg = ServeConfig(batch=batch, max_len=prompt_len + n_new + 1)
    eng = Engine(cfg, model, scfg)

    for mod in mods.values():
        mod.launches = 0
    toks, logits = eng.generate(prompts, n_new, return_logits=True)
    launches = {name: mod.launches for name, mod in mods.items()}
    print(f"[e2e] launches: {launches}")
    for name in names:
        want = per_prefill.get(name, 0) + n_new * per_step.get(name, 0)
        check(launches[name] == want,
              f"{name} launches {launches[name]} != {want}")
    check(tuple(toks.shape) == (batch, n_new), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token ids out of range")
    check(tuple(logits.shape) == (n_new, batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "logits not finite")

    st = eng.stats()
    dec = st["phases"]["decode"]
    steady = dec["steady_mean_s"]
    for mod in mods.values():
        mod.launches = 0
    warm = warm_ttft_ms(eng, prompts)
    for name, n in per_prefill.items():
        check(mods[name].launches == 3 * n,
              f"{name}: {mods[name].launches} launches in 3 prefills")
    print(f"[e2e] {k_name} route: TTFT {st['ttft_s'] * 1e3:.2f} ms (first "
          f"prefill of the process), warm TTFT {warm:.2f} ms; decode "
          f"{steady * 1e3:.3f} ms/step mean, "
          f"{dec['steady_p50_s'] * 1e3:.3f} ms p50 over {dec['steps']} "
          f"steps; {batch / steady:.1f} tokens/s")

    cfg_plain = p_cfg(eng.cfg)
    held, h_toks, h_logits = prompts, toks, logits
    if hold_prompt:
        held = prompts[:, :hold_prompt]
        print(f"[e2e] the plain route and the comparison at {batch} x "
              f"{hold_prompt} prompt tokens (the first of the same prompts), "
              f"{n_new} new, where the plain route fits beside the weights; "
              f"the kernel route again at that shape:")
        h_eng = Engine(eng.cfg, model, scfg)
        h_toks, h_logits = h_eng.generate(held, n_new, return_logits=True)
        hdec = h_eng.stats()["phases"]["decode"]
        print(f"[e2e] {k_name} route at {batch} x {hold_prompt}: warm TTFT "
              f"{warm_ttft_ms(h_eng, held):.2f} ms; decode "
              f"{hdec['steady_mean_s'] * 1e3:.3f} ms/step mean")
        del h_eng
    if cfg.moe:
        check_moe_layer(eng.cfg, cfg_plain, model, held)
    # plain route, same weights: timed through the same Engine.generate,
    # then the kernel route's tokens fed to it for the logits comparison
    plain = Engine(cfg_plain, model, scfg)
    plain.generate(held, n_new)
    pdec = plain.stats()["phases"]["decode"]
    print(f"[e2e] {p_name} route: warm TTFT "
          f"{warm_ttft_ms(plain, held):.2f} ms; decode "
          f"{pdec['steady_mean_s'] * 1e3:.3f} ms/step mean, "
          f"{pdec['steady_p50_s'] * 1e3:.3f} ms p50 over {pdec['steps']} "
          f"steps")
    cache, last = plain.prefill(held)
    diffs = [err(last, h_logits[0])]
    agree = [(last.argmax(-1) == h_logits[0].argmax(-1)).float().mean()
             .item()]
    with torch.no_grad():
        for i in range(n_new - 1):
            lg, cache = model_mod.decode_step(
                cfg_plain, model, {"tokens": h_toks[:, i:i + 1]}, cache)
            lg = lg[:, -1]
            diffs.append(err(lg, h_logits[i + 1]))
            agree.append((lg.argmax(-1) == h_logits[i + 1].argmax(-1))
                         .float().mean().item())
    del plain, cache
    mean_agree = statistics.fmean(agree)
    print(f"[e2e] kernel vs plain route logits: prefill max abs diff "
          f"{diffs[0]:.4g}, decode steps max {max(diffs[1:]):.4g} (atol "
          f"{atol}; max |logit| {h_logits.abs().max().item():.3g}); "
          f"greedy argmax agreement {mean_agree:.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(max(diffs) <= atol,
          f"route logits differ by {max(diffs)} > {atol}")
    if cfg.moe and moe_registry:
        check_moe_registry(eng.cfg, model, prompts)
    if profile:
        from repro_torch.launch import profile as profile_mod
        profile_mod.profile_serving(eng.cfg, batch=batch,
                                    prompt_len=prompt_len, model=model)
    ctx = {"cfg": eng.cfg, "model": model, "prompts": prompts, "scfg": scfg,
           "mods": mods, "toks": toks, "logits": logits,
           "ttft_ms": st["ttft_s"] * 1e3, "warm_ttft_ms": warm,
           "step_ms": steady * 1e3, "step_p50_ms": dec["steady_p50_s"] * 1e3}
    return launches, ctx


def plan_built(kernel: str, spec, cfg, cache_dtype) -> bool:
    """Whether the kernel is built for a plan's launch spec at ``cfg``'s
    serving widths (the SSD decode step walks any M that divides H)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    f, mode = spec.factor, spec.mode
    if kernel == "flash_attention":
        return fa.built(f, mode, cfg.head_dim_, cfg.activation_dtype)
    if kernel == "decode_attention":
        return da.built(f, mode, cfg.n_heads // cfg.n_kv_heads,
                        cfg.head_dim_, cache_dtype)
    if kernel == "ssd_scan":
        return ss.built(f, mode)
    nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    return kernel == "ssd_decode" and nh % f == 0


def t1_bits(kernel: str, spec, cfg, scfg, gen) -> bool:
    """Whether the kernel at a plan's launch spec gives T1's bits on random
    inputs at ``cfg``'s serving shapes (B 8, prompt 512, the cache)."""
    from repro_torch.core.ir import PumpSpec
    from repro_torch.kernels import ops
    act, b = cfg.activation_dtype, scfg.batch
    if kernel == "flash_attention":
        q = randn(gen, b, cfg.n_heads, 512, cfg.head_dim_, dtype=act)
        k, v = (randn(gen, b, cfg.n_kv_heads, 512, cfg.head_dim_, dtype=act)
                for _ in range(2))
        args, kw = (q, k, v), dict(causal=True)
    elif kernel == "decode_attention":
        cdt = getattr(torch, scfg.cache_dtype)
        q = randn(gen, b, cfg.n_heads, cfg.head_dim_, dtype=act)
        kc, vc = (randn(gen, b, cfg.n_kv_heads, scfg.max_len, cfg.head_dim_,
                        dtype=cdt) for _ in range(2))
        args, kw = (q, kc, vc, scfg.max_len - 2), {}
    else:
        s_ = cfg.ssm
        nh = s_.expand * cfg.d_model // s_.head_dim
        x, dt, a, bm, cm = ssd_inputs(gen, b, 512, nh, s_.n_groups,
                                      s_.state_dim, s_.head_dim, act)
        if kernel == "ssd_scan":
            args, kw = (x, dt, a, bm, cm), dict(chunk=s_.chunk,
                                               final_state=True)
        else:
            st = randn(gen, b, nh, s_.state_dim, s_.head_dim)
            args = (st, x[:, 0].contiguous(), dt[:, 0].contiguous(), a,
                    bm[:, 0].contiguous(), cm[:, 0].contiguous())
            kw = {}
    fn = getattr(ops, kernel)
    got, want = fn(*args, **kw, pump=spec), fn(*args, **kw, pump=PumpSpec(1))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return all(same_bits(g_.float(), w_.float()) for g_, w_ in zip(got, want))


def phase_registry(ctx, per_prefill: dict, per_step: dict, atol: float,
                   reg):
    """The model of ``ctx`` served again, on the same weights and prompts,
    through ``Engine`` with ``kernel_plan='measure'`` on the plan registry
    ``reg``: the warmup plans the bucket grid (printed: kernel, bucket,
    factor, mode, launch spec, measured or replayed); every plan must be
    measured, at the ``hopper`` tier and inside its kernel's built set.
    Then ``generate`` with the launch counts of ``per_prefill`` /
    ``per_step``, no registry miss and no fallback after the warmup, TTFT
    and ms/step beside the direct route's, every step's logits within
    ``atol`` of the direct route's, the tokens identical where every chosen
    plan gives T1's bits, and the host µs of a warm registry call.
    Returns the warmup report."""
    from repro_torch.compiler.registry import set_default_registry
    from repro_torch.core.ir import PumpSpec
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine
    cfg = dataclasses.replace(ctx["cfg"], kernel_plan="measure")
    scfg, model, prompts = ctx["scfg"], ctx["model"], ctx["prompts"]
    mods, n_new = ctx["mods"], ctx["toks"].shape[1]
    old = set_default_registry(reg)
    n_before = len(reg.plans())
    try:
        eng = Engine(cfg, model, scfg)
        st0 = eng.stats()
        print(f"[registry] {cfg.name}: warmup {st0['warmup_s']:.3f} s, "
              f"{st0['plans_warmed']} plans, {st0['warmup_measured']} "
              f"measured, {st0['warmup_failed']} failed")
        cdt = getattr(torch, scfg.cache_dtype)
        specs, plan_spec = {}, {}
        for r in eng.warmup_report:
            print(f"[registry]   {r['kernel']} {r['args']}: factor "
                  f"{r['factor']}{r['mode']}, launch {r.get('launch')}, "
                  f"{'replayed' if r['replayed'] else 'measured'} "
                  f"(winner {r['winner_us']} us), tiers {r['tiers']}, "
                  f"{r['time_s']:.3f} s")
            check("error" not in r, f"warmup failed: {r}")
        for pl in reg.plans()[n_before:]:          # this model's plans
            spec = PumpSpec(int(pl["launch"][1:]), pl["launch"][0])
            plan_spec[pl["kernel"], tuple(pl["args"])] = spec
            check(pl["measured"] and not pl["replayed"],
                  f"plan not measured: {pl}")
            check(plan_built(pl["kernel"], spec, cfg, cdt),
                  f"plan outside the built set: {pl}")
            specs.setdefault(pl["kernel"], set()).add(spec)
        check(all(r["tiers"] == ["hopper"] for r in eng.warmup_report),
              "a warmed plan is not at the hopper tier")
        gen = torch.Generator(device="cuda").manual_seed(7)
        bits = all(t1_bits(k_, sp, cfg, scfg, gen) for k_, sps in
                   specs.items() for sp in sps if sp.factor > 1)
        hits0, misses0 = reg.stats.hits, reg.stats.misses

        for mod in mods.values():
            mod.launches = 0
        toks, logits = eng.generate(prompts, n_new, return_logits=True)
        launches = {name: mod.launches for name, mod in mods.items()}
        print(f"[registry] launches: {launches}")
        for name in mods:
            want = per_prefill.get(name, 0) + n_new * per_step.get(name, 0)
            check(launches[name] == want,
                  f"{name} launches {launches[name]} != {want}")
        st = eng.stats()
        hits, misses = reg.stats.hits - hits0, reg.stats.misses - misses0
        print(f"[registry] after warmup: {hits} hits, {misses} misses, hit "
              f"rate {hits / max(hits + misses, 1):.4f}, "
              f"{reg.stats.fallbacks} fallbacks; registry "
              f"{st['registry']}")
        check(misses == 0 and hits > 0 and reg.stats.fallbacks == 0,
              f"registry after warmup: {hits} hits, {misses} misses, "
              f"{reg.stats.fallbacks} fallbacks")

        # host time spreads between runs, so each route runs again on a
        # fresh engine, adjacent (direct, then measure, whose warmup is
        # all hits now), beside the checked run and the direct route's
        # run of the e2e phase
        print(f"[registry] direct route, e2e phase: TTFT "
              f"{ctx['ttft_ms']:.2f} ms (first prefill of the process), "
              f"warm TTFT {ctx['warm_ttft_ms']:.2f} ms; decode "
              f"{ctx['step_ms']:.3f} ms/step mean, {ctx['step_p50_ms']:.3f} "
              f"ms p50")
        for label, e_ in (("measure route, checked run", eng),
                          ("direct route, again", None),
                          ("measure route, again", None)):
            if e_ is None:
                route = label.split()[0]
                e_ = Engine(dataclasses.replace(cfg, kernel_plan=route),
                            model, scfg)
                e_.generate(prompts, n_new)
            st_ = e_.stats()
            dec = st_["phases"]["decode"]
            warm = warm_ttft_ms(e_, prompts)
            print(f"[registry] {label}: TTFT {st_['ttft_s'] * 1e3:.2f} ms, "
                  f"warm TTFT {warm:.2f} ms; decode "
                  f"{dec['steady_mean_s'] * 1e3:.3f} ms/step mean, "
                  f"{dec['steady_p50_s'] * 1e3:.3f} ms p50 over "
                  f"{dec['steps']} steps")
        check(reg.stats.misses == misses0 and reg.stats.fallbacks == 0,
              "the timing runs missed or fell back")

        diff = err(logits, ctx["logits"])
        agree = (logits.argmax(-1) == ctx["logits"].argmax(-1)).float() \
            .mean().item()
        same = torch.equal(toks, ctx["toks"])
        print(f"[registry] measure vs direct route: logits max abs diff "
              f"{diff:.4g} (atol {atol}), tokens identical {same}, argmax "
              f"agreement {agree:.4f}; every plan gives T1's bits: {bits}")
        check(diff <= atol, f"measure route logits differ by {diff}")
        check(same or not bits, "tokens differ though every plan gives "
                                "T1's bits")

        # host cost of one warm call: the registry wrapper (one dict
        # lookup, then the op) against the op called directly at its spec
        with torch.no_grad():
            if cfg.ssm:
                s_ = cfg.ssm
                nh = s_.expand * cfg.d_model // s_.head_dim
                x, dt, a, bm, cm = ssd_inputs(
                    gen, scfg.batch, 1, nh, s_.n_groups, s_.state_dim,
                    s_.head_dim, cfg.activation_dtype)
                st_ = randn(gen, scfg.batch, nh, s_.state_dim, s_.head_dim)
                args = (st_, x[:, 0].contiguous(), dt[:, 0].contiguous(), a,
                        bm[:, 0].contiguous(), cm[:, 0].contiguous())
                name, call = "ssd_decode", reg.ssd_decode
                bucket = (scfg.batch, nh, s_.head_dim, s_.state_dim)
            else:
                q = randn(gen, scfg.batch, cfg.n_heads, cfg.head_dim_,
                          dtype=cfg.activation_dtype)
                kc = randn(gen, scfg.batch, cfg.n_kv_heads, scfg.max_len,
                           cfg.head_dim_, dtype=cdt)
                args = (q, kc, kc, scfg.max_len - 2)
                name, call = "decode_attention", reg.decode_attention
                bucket = (scfg.batch, cfg.n_heads, reg.policy.bucket_seq(
                    min(reg.policy.bucket_pos(scfg.max_len - 2),
                        scfg.max_len)), cfg.head_dim_)
            call(*args)
            spec = plan_spec[name, bucket]
            op = getattr(ops, name)
            # host time spreads between samples: the least of five
            # interleaved samples of each
            us_reg, us_op = (min(v) for v in zip(*[
                (host_us(lambda: call(*args)),
                 host_us(lambda: op(*args, pump=spec))) for _ in range(5)]))
            # the warm hit alone: ``_spec`` on a resident key of this
            # kernel (one dict lookup and the hit count), no op
            lk = next(k for k in reg._lookup if k[0] == name)
            us_hit = min(host_us(lambda: reg._spec(lk, name, None, None,
                                                   None), iters=5000)
                         for _ in range(5))
        print(f"[registry] host time of one warm {name} call (least of 5 "
              f"interleaved samples of 200 calls): registry {us_reg:.2f} us, "
              f"the op at its spec {us_op:.2f} us, the difference "
              f"{us_reg - us_op:.2f} us; the warm hit alone (least of 5 "
              f"samples of 5000) {us_hit:.3f} us")
        return eng.warmup_report
    finally:
        set_default_registry(old)


def phase_registry_replay(archs, reg_cache) -> None:
    """A fresh registry on the same compile cache, after
    ``compiler.clear_memo()`` (a new process): warming the same grids must
    replay every plan with zero measurements."""
    from repro_torch import compiler
    from repro_torch.compiler.registry import PlanRegistry
    from repro_torch.models import transformer
    compiler.clear_memo()
    reg = PlanRegistry(cache=reg_cache())
    t0 = time.perf_counter()
    report = []
    for cfg, scfg in archs:
        reqs = transformer.plan_requests(
            dataclasses.replace(cfg, kernel_plan="measure"), scfg.batch,
            scfg.max_len, dtype=cfg.dtype, cached=True,
            cache_dtype=getattr(torch, scfg.cache_dtype))
        report += reg.warmup(reqs)
    wall = time.perf_counter() - t0
    replayed = sum(1 for r in report if r["replayed"])
    print(f"[registry] replay: a fresh registry after clear_memo() warmed "
          f"{len(report)} plans in {wall:.3f} s, {replayed} replayed, "
          f"measure_s {reg.stats.measure_s}, compile_s "
          f"{reg.stats.compile_s:.3f}")
    check(report and replayed == len(report)
          and reg.stats.measure_s == 0.0
          and all("error" not in r for r in report),
          f"replay measured or failed: {report}")


def stream_run(eng, reqs, **kw):
    """One stream through ``Engine.serve_stream`` with its logits collected:
    (completed by rid, step snapshots, wall seconds, engine timer calls of
    each phase in the run).  Each snapshot also gets ``t``, the seconds
    from the stream's start to the end of its step."""
    def calls():
        return {ph: len(eng.timer.steady.get(ph, []))
                + (ph in eng.timer.cold_s)
                for ph in ("prefill", "prefill_chunk", "decode")}
    snaps, before = [], calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.serve_stream(
        reqs, collect_logits=True, step_time_ms=1.0,
        step_hook=lambda sn: snaps.append(
            dict(sn, t=time.perf_counter() - t0)), **kw)
    wall = time.perf_counter() - t0
    after = calls()
    return ({r.rid: r for r in done}, snaps, wall,
            {ph: after[ph] - before[ph] for ph in after})


def hold_first_difference(label, got, want, atol):
    """Each request's logits against a reference run's, step by step up to
    the first token where the two differ; that token may differ only where
    the reference's top-2 logit gap at the step is under ``atol``.  ``got``
    / ``want``: rid -> (tokens (n,), fp32 logits (n, V)).  Prints the steps
    held out of all; returns the number of identical requests and the
    largest logit difference held."""
    same, worst, held = 0, 0.0, 0
    for rid, (g_toks, g_lg) in sorted(got.items()):
        w_toks, w_lg = want[rid]
        check(len(g_toks) == len(w_toks), f"{label} rid {rid}: lengths")
        for i in range(len(w_toks)):
            held += 1
            e = float(np.abs(g_lg[i] - w_lg[i]).max())
            worst = max(worst, e)
            check(e <= atol, f"{label} rid {rid} step {i}: logits differ "
                             f"by {e} > {atol}")
            if g_toks[i] != w_toks[i]:
                top2 = np.sort(w_lg[i])[-2:]
                gap = float(top2[1] - top2[0])
                check(gap < atol, f"{label} rid {rid} step {i}: token "
                                  f"{g_toks[i]} != {w_toks[i]} at a top-2 "
                                  f"gap of {gap} >= {atol}")
                print(f"[stream] {label} rid {rid}: first different token "
                      f"at step {i} (top-2 gap {gap:.4g})")
                break
        else:
            same += 1
    total = sum(len(toks) for toks, _ in got.values())
    print(f"[stream] {label}: {held} of {total} steps held up to the first "
          f"difference")
    return same, worst


def hold_every_step(label, cfg_plain, model, reqs, done, atol):
    """Every step of every streamed request against the plain route
    (``cfg_plain``: plain attention / SSD in PyTorch, no kernel) on the
    same weights and the same tokens: one forward over the prompt and the
    tokens the stream emitted, whose logits at the prompt's last position
    and after each emitted token are the ones each step of the stream
    produced.  Every step is held, within ``atol``, however the stream's
    tokens came out; where the stream's token is not the plain route's
    argmax, the plain route's top-2 gap there must be under ``atol``.
    The sequence is padded at its end (which moves no earlier position)
    to whole SSD chunks.  Returns (steps held, largest difference)."""
    from repro_torch.models import model as model_mod
    chunk = cfg_plain.ssm.chunk if cfg_plain.ssm else 1
    held, worst, flips = 0, 0.0, 0
    for r in reqs:
        toks, lg = done[r.rid].tokens, done[r.rid].logits
        n, plen = len(toks), r.prompt_len
        seq = np.concatenate([r.tokens, toks[:-1]]).astype(np.int64)
        seq = np.pad(seq, (0, -len(seq) % chunk))
        with torch.no_grad():
            want, _ = model_mod.forward(
                cfg_plain, model, {"tokens": torch.from_numpy(seq)[None]
                                   .cuda()})
        want = want[0, plen - 1:plen - 1 + n].float().cpu().numpy()
        e = float(np.abs(lg - want).max())
        worst = max(worst, e)
        check(e <= atol, f"{label} rid {r.rid}: logits differ from the "
                         f"plain route's by {e} > {atol}")
        for i in np.flatnonzero(toks != want.argmax(-1)):
            top2 = np.sort(want[i])[-2:]
            gap = float(top2[1] - top2[0])
            check(gap < atol, f"{label} rid {r.rid} step {i}: token "
                              f"{toks[i]} is not the plain route's argmax "
                              f"at a top-2 gap of {gap} >= {atol}")
            flips += 1
        held += n
    print(f"[stream] {label} vs the plain route, teacher-forced: {held} of "
          f"{held} steps held, logits within {worst:.4g} (atol {atol}), "
          f"{flips} tokens off the plain route's argmax at a near-tie")
    return held, worst


def admission_groups(snaps, reqs, budget=None):
    """Fresh grouped prefills of a stream without preemption: the distinct
    prompt lengths admitted in each step (a prompt longer than the chunk
    ``budget`` takes continuation chunks instead)."""
    plen = {r.rid: r.prompt_len for r in reqs}
    return sum(len({plen[rid] for rid in sn["admitted"]
                    if budget is None or plen[rid] <= budget})
               for sn in snaps)


def stream_report(label, done, snaps, wall, n_slots):
    """Prints a stream's tokens/s, steps, ms a step, occupancy and TTFT p50:
    from admission (the scheduler's ``ttft_s``) and from arrival (the
    start of the arrival step to the end of the first token's step, the
    queue wait included).  Returns the tokens served."""
    occ = [sn["occupancy"] for sn in snaps]
    ends = [sn["t"] for sn in snaps]
    ttft = sorted(r.ttft_s for r in done.values())
    from_arrival = sorted(
        ends[r.arrival + r.ttft_steps] - (ends[r.arrival - 1]
                                          if r.arrival else 0.0)
        for r in done.values())
    tokens = sum(len(r.tokens) for r in done.values())
    print(f"[stream] {label}: {len(done)} requests, {tokens} tokens in "
          f"{wall:.3f} s ({tokens / wall:.1f} tokens/s), {len(snaps)} "
          f"scheduler steps ({wall / len(snaps) * 1e3:.2f} ms a step), "
          f"occupancy peak {max(occ)}/{n_slots} mean "
          f"{statistics.fmean(occ):.2f}, TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.2f} ms from admission, "
          f"{from_arrival[len(ttft) // 2] * 1e3:.2f} ms from arrival, "
          f"{sum(r.preemptions for r in done.values())} preemptions")
    return tokens


def solo_runs(eng, reqs):
    """Each request alone through ``generate``: rid -> (tokens, logits),
    and the summed wall seconds."""
    out, wall = {}, 0.0
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, lg = eng.generate(torch.from_numpy(r.tokens.astype(np.int64))
                                [None], r.n_new, return_logits=True)
        wall += time.perf_counter() - t0
        out[r.rid] = (toks[0].cpu().numpy(), lg[:, 0].cpu().numpy())
    return out, wall


def phase_stream_qwen3(ctx, plain):
    """qwen3-0.6b's stream on the e2e phase's weights, ``Engine`` batch 8,
    ``max_len`` 577, direct route: a FIFO stream of 16 requests (prompts
    128 / 256 / 512, 16 or 32 new tokens) with its launches counted (28
    flash a grouped prefill, 28 decode attentions a decode step), held to
    each request run alone and to the reference harness's 1.3x bar; the
    same trace with ``prefill_chunk_tokens=256``; the trace with
    priorities, ``lowest_priority`` preemption and 4 slots.  Every step of
    each stream is also held to the plain route (``plain``, a config
    transform) on the same tokens.  Returns the stream's launches."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.engine import Engine
    cfg, scfg = ctx["cfg"], ctx["scfg"]
    eng = Engine(cfg, ctx["model"], scfg)
    cfg_plain = plain(cfg)
    wl = dict(seed=23, prompt_lens=(128, 256, 512), new_tokens=(16, 32),
              arrival_rate=0.5, vocab=cfg.vocab_size)
    reqs = sched.synthetic_workload(16, **wl)
    # the same requests with priorities 0 / 1 from a seeded draw of their
    # own (synthetic_workload's priorities knob would draw them between the
    # requests' other draws, giving another trace), so each request can be
    # held to its FIFO run
    prio = np.random.default_rng(23).integers(0, 2, len(reqs))
    pre_reqs = [dataclasses.replace(r, priority=int(p_))
                for r, p_ in zip(reqs, prio)]
    launches = {"flash_attention": 0, "decode_attention": 0}

    def counted(trace, **kw):
        fa.launches = da.launches = 0
        out = stream_run(eng, trace, **kw)
        launches["flash_attention"] += fa.launches
        launches["decode_attention"] += da.launches
        return out, fa.launches, da.launches

    (done, snaps, wall, calls), n_fa, n_da = counted(reqs)
    groups = admission_groups(snaps, reqs)
    print(f"[stream] qwen3 FIFO launches: flash {n_fa} ({groups} admission "
          f"groups), decode attention {n_da} ({calls['decode']} decode "
          f"steps)")
    check(n_fa == cfg.n_layers * groups == cfg.n_layers * calls["prefill"],
          f"flash launches {n_fa} != {cfg.n_layers} x {groups} groups")
    check(n_da == cfg.n_layers * calls["decode"],
          f"decode launches {n_da} != {cfg.n_layers} x {calls['decode']}")
    tokens = stream_report("qwen3 FIFO", done, snaps, wall, 8)
    fifo = {rid: (r.tokens, r.logits) for rid, r in done.items()}
    check(all(np.isfinite(r.logits).all() and r.logits.shape ==
              (len(r.tokens), cfg.vocab_size) for r in done.values()),
          "stream logits not finite or of the wrong shape")
    hold_every_step("qwen3 FIFO", cfg_plain, ctx["model"], reqs, done,
                    ATOL_E2E_LOGITS)
    solo, solo_wall = solo_runs(eng, reqs)
    same, worst = hold_first_difference("qwen3 FIFO vs solo", fifo, solo,
                                        ATOL_E2E_LOGITS)
    # the device's share of the stream: the same stream again under the
    # profiler (its device time; the wall is the unprofiled run's)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.serve_stream(reqs, step_time_ms=1.0)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    print(f"[stream] qwen3 FIFO device busy {busy * 1e3:.1f} ms of "
          f"{wall * 1e3:.1f} ms wall ({1 - busy / wall:.1%} idle), "
          f"{len(events) / len(snaps):.0f} device kernels a step"
          if events else "[stream] qwen3 FIFO: the profiler recorded no "
          "device events; device time not measured")
    speed = (tokens / wall) / (tokens / solo_wall)
    print(f"[stream] qwen3 FIFO vs each request alone: {same}/{len(reqs)} "
          f"requests identical, logits within {worst:.4g} (atol "
          f"{ATOL_E2E_LOGITS}); {tokens / wall:.1f} tokens/s streamed, "
          f"{tokens / solo_wall:.1f} alone in sequence ({solo_wall:.3f} s): "
          f"{speed:.2f}x (bar 1.3x)")
    check(speed >= 1.3, f"stream {speed:.2f}x sequential < 1.3x")

    (done, snaps, wall, calls), n_fa, n_da = counted(
        reqs, prefill_chunk_tokens=256)
    groups = admission_groups(snaps, reqs, budget=256)
    n_long = sum(r.prompt_len > 256 for r in reqs)
    print(f"[stream] qwen3 chunked (256 tokens a step): flash {n_fa} "
          f"({groups} groups), {calls['prefill_chunk']} continuation chunks "
          f"for {n_long} 512-token prompts, decode attention {n_da}")
    check(n_fa == cfg.n_layers * groups and n_da == cfg.n_layers
          * calls["decode"] and calls["prefill_chunk"] == 2 * n_long,
          "chunked stream launches")
    check(any(sn["prefilling"] for sn in snaps), "no chunked prefill")
    stream_report("qwen3 chunked", done, snaps, wall, 8)
    hold_every_step("qwen3 chunked", cfg_plain, ctx["model"], reqs, done,
                    ATOL_E2E_LOGITS)
    same, worst = hold_first_difference(
        "qwen3 chunked vs FIFO",
        {rid: (r.tokens, r.logits) for rid, r in done.items()}, fifo,
        ATOL_E2E_LOGITS)
    print(f"[stream] qwen3 chunked vs FIFO: {same}/{len(reqs)} identical, "
          f"logits within {worst:.4g}")

    (done, snaps, wall, calls), n_fa, n_da = counted(
        pre_reqs, max_slots=4, preempt_policy="lowest_priority")
    check(len(done) == len(pre_reqs), "preempted stream lost requests")
    n_pre = sum(r.preemptions for r in done.values())
    check(n_pre >= 1, "no preemption in the priority stream")
    check(n_fa == cfg.n_layers * calls["prefill"]
          and n_da == cfg.n_layers * calls["decode"],
          "preempted stream launches")
    stream_report("qwen3 preempted (4 slots)", done, snaps, wall, 4)
    hold_every_step("qwen3 preempted", cfg_plain, ctx["model"], pre_reqs,
                    done, ATOL_E2E_LOGITS)
    same, worst = hold_first_difference(
        "qwen3 preempted vs FIFO",
        {rid: (r.tokens, r.logits) for rid, r in done.items()}, fifo,
        ATOL_E2E_LOGITS)
    print(f"[stream] qwen3 preempted vs FIFO: {same}/{len(reqs)} "
          f"identical, logits within {worst:.4g}")
    print(f"[stream] qwen3 launches over the three streams: {launches}")
    return launches


def phase_stream_mamba2(ctx, plain):
    """mamba2-1.3b's stream on the e2e phase's weights: 8 requests (prompts
    256 / 512, 16 or 32 new tokens), ``prefill_chunk_tokens=256``, so a
    512-token prompt takes two continuation chunks; the scan launches 48
    times a grouped prefill and a chunk, the SSD decode step 48 times a
    decode step; logits held to each request alone, and every step to the
    plain route (``plain``) on the same tokens.  Returns the stream's
    launches."""
    from repro_torch.kernels import ssd_decode as sd
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.engine import Engine
    cfg, scfg = ctx["cfg"], ctx["scfg"]
    eng = Engine(cfg, ctx["model"], scfg)
    reqs = sched.synthetic_workload(8, seed=23, prompt_lens=(256, 512),
                                    new_tokens=(16, 32), arrival_rate=0.5,
                                    vocab=cfg.vocab_size)
    ss.launches = sd.launches = 0
    done, snaps, wall, calls = stream_run(eng, reqs,
                                          prefill_chunk_tokens=256)
    launches = {"ssd_scan": ss.launches, "ssd_decode": sd.launches}
    groups = admission_groups(snaps, reqs, budget=256)
    n_long = sum(r.prompt_len > 256 for r in reqs)
    print(f"[stream] mamba2 chunked launches: {launches} ({groups} groups, "
          f"{calls['prefill_chunk']} continuation chunks, {calls['decode']} "
          f"decode steps)")
    check(calls["prefill_chunk"] == 2 * n_long
          and calls["prefill"] == groups, "mamba2 stream prefills")
    check(launches["ssd_scan"] == cfg.n_layers * (groups + 2 * n_long),
          f"scan launches {launches['ssd_scan']}")
    check(launches["ssd_decode"] == cfg.n_layers * calls["decode"],
          f"SSD decode launches {launches['ssd_decode']}")
    tokens = stream_report("mamba2 chunked", done, snaps, wall, 8)
    hold_every_step("mamba2 chunked", plain(cfg), ctx["model"], reqs, done,
                    ATOL_E2E_SSM_LOGITS)
    solo, solo_wall = solo_runs(eng, reqs)
    same, worst = hold_first_difference(
        "mamba2 chunked vs solo",
        {rid: (r.tokens, r.logits) for rid, r in done.items()}, solo,
        ATOL_E2E_SSM_LOGITS)
    print(f"[stream] mamba2 chunked vs each request alone: {same}/"
          f"{len(reqs)} identical, logits within {worst:.4g} (atol "
          f"{ATOL_E2E_SSM_LOGITS}); {tokens / wall:.1f} tokens/s streamed, "
          f"{tokens / solo_wall:.1f} alone in sequence")
    return launches


def phase_decode_loop():
    """Decode attention inside qwen3-0.6b's serving loop: ``launch.profile``
    over a prefill and 8 decode steps (batch 8, prompt 512); prints the
    kernel's device time per call beside the step's busy and wall time."""
    from repro_torch.launch import profile as profile_mod
    dec = profile_mod.main(["--arch", "qwen3-0.6b",
                            "--attention-impl", "pallas"])["decode"]
    if dec is None:
        print("[decode] in qwen3's serving loop: device time not measured")
        return
    calls = [v for k, v in dec["kernels"].items() if "decode_split" in k]
    check(bool(calls), "decode attention did not run in the serving loop")
    ms, n = (sum(v[i] for v in calls) for i in (0, 1))
    print(f"[decode] in qwen3's serving loop (launch.profile): "
          f"{ms / n * 1e3:.2f} us a call, {n:.0f} calls a step, {ms:.4f} of "
          f"{dec['busy_ms']:.3f} busy ms a step ({dec['wall_ms']:.3f} ms "
          f"wall, {dec['idle']:.1%} idle)")


def phase_whisper(atol: float) -> dict:
    """whisper-base at full width (6 encoder and 6 decoder layers, seeded
    bf16 weights, fp32 cache): seeded frames (8, 1500, 512) through
    ``encdec.encode`` on both routes (6 non-causal flash launches on the
    kernel route, none on the plain one), then ``Engine(batch 8, max_len
    448).generate`` of 64 tokens after a 384-token prompt on each route's
    own encoder output (6 flash launches a prefill, 6 decode attentions a
    step; cross-attention is plain on both routes).  The plain route is
    teacher-forced on the kernel route's tokens and every step's logits
    held within ``atol``.  Prints the encoder's ms, TTFT, ms a step and the
    peak memory, then ``launch.profile``'s encoder / prefill / decode
    rows.  Returns the kernel route's launches (encoder, prefill and
    steps)."""
    import gc
    from repro_torch.configs.base import load_arch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import profile as profile_mod
    from repro_torch.launch.timing import Timer
    from repro_torch.models import convert, encdec
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import Engine, ServeConfig
    batch, n_new = 8, WHISPER_MAX_LEN - WHISPER_PROMPT
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(load_arch("whisper-base"),
                              attention_impl="pallas")
    cfg_plain = dataclasses.replace(cfg, attention_impl="xla_chunked")
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    model = convert.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                         device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    prompts = torch.randint(0, cfg.vocab_size, (batch, WHISPER_PROMPT),
                            generator=torch.Generator().manual_seed(1))
    print(f"[whisper] {cfg.name}: {n_enc} encoder and {n_dec} decoder "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads x {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e6:.1f} M seeded bf16 weights; "
          f"frames {tuple(frames.shape)} (stub frontend), prompt "
          f"{tuple(prompts.shape)}, {n_new} new, max_len {WHISPER_MAX_LEN}")

    def counts():
        return {"flash_attention": fa.launches,
                "decode_attention": da.launches}

    fa.launches = da.launches = 0
    with torch.no_grad():
        enc_k = encdec.encode(cfg, model, frames)
    check(counts() == {"flash_attention": n_enc, "decode_attention": 0},
          f"whisper encode launches {counts()}")
    scfg = ServeConfig(batch=batch, max_len=WHISPER_MAX_LEN)
    eng = Engine(cfg, model, scfg)
    toks, logits = eng.generate(prompts, n_new, enc_out=enc_k,
                                return_logits=True)
    launches = counts()
    want = {"flash_attention": n_enc + n_dec,
            "decode_attention": n_new * n_dec}
    print(f"[whisper] launches: encoder {n_enc} flash, then {launches}")
    check(launches == want, f"whisper launches {launches} != {want}")
    with torch.no_grad():
        enc_p = encdec.encode(cfg_plain, model, frames)
    check(counts() == launches, "the plain encoder launched a kernel")
    check(tuple(enc_k.shape) == (batch, cfg.encoder_seq, cfg.d_model)
          and bool(torch.isfinite(enc_k).all()), "encoder output")
    check(tuple(toks.shape) == (batch, n_new)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"tokens {tuple(toks.shape)}")
    check(tuple(logits.shape) == (n_new, batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "logits not finite")
    timer = Timer()
    with torch.no_grad():
        enc_ms = timer.ms(lambda: encdec.encode(cfg, model, frames), iters=5)
        enc_plain_ms = timer.ms(
            lambda: encdec.encode(cfg_plain, model, frames), iters=5)
    del timer
    st = eng.stats()
    dec = st["phases"]["decode"]
    warm = warm_ttft_ms(eng, prompts, enc_out=enc_k)
    print(f"[whisper] encoder: kernel route {enc_ms:.3f} ms, plain route "
          f"{enc_plain_ms:.3f} ms; output rel err {rel_err(enc_k, enc_p):.3g}"
          f" (max |value| {enc_p.float().abs().max().item():.3g})")
    print(f"[whisper] pallas route: TTFT {st['ttft_s'] * 1e3:.2f} ms (first "
          f"prefill of the process), warm TTFT {warm:.2f} ms; decode "
          f"{dec['steady_mean_s'] * 1e3:.3f} ms/step mean, "
          f"{dec['steady_p50_s'] * 1e3:.3f} ms p50 over {dec['steps']} "
          f"steps; {batch / dec['steady_mean_s']:.1f} tokens/s")

    plain = Engine(cfg_plain, model, scfg)
    plain.generate(prompts, n_new, enc_out=enc_p)
    pdec = plain.stats()["phases"]["decode"]
    print(f"[whisper] xla_chunked route: warm TTFT "
          f"{warm_ttft_ms(plain, prompts, enc_out=enc_p):.2f} ms; decode "
          f"{pdec['steady_mean_s'] * 1e3:.3f} ms/step mean, "
          f"{pdec['steady_p50_s'] * 1e3:.3f} ms p50 over {pdec['steps']} "
          f"steps")
    cache, last = plain.prefill(prompts, enc_p)
    diffs = [err(last, logits[0])]
    with torch.no_grad():
        for i in range(n_new - 1):
            lg, cache = model_mod.decode_step(
                plain.cfg, model, {"tokens": toks[:, i:i + 1],
                                   "enc_out": enc_p}, cache)
            diffs.append(err(lg[:, -1], logits[i + 1]))
    del plain, cache
    print(f"[whisper] kernel vs plain route logits: prefill max abs diff "
          f"{diffs[0]:.4g}, decode steps max {max(diffs[1:]):.4g} (atol "
          f"{atol}; max |logit| {logits.abs().max().item():.3g}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB")
    check(max(diffs) <= atol, f"whisper route logits differ by {max(diffs)}"
          f" > {atol}")
    profile_mod.profile_serving(eng.cfg, batch=batch,
                                prompt_len=WHISPER_PROMPT, model=model)
    return launches


def phase_vlm_forward(ctx, plain_route, atol: float) -> dict:
    """internvl2-2b's image-prefixed forward on the e2e phase's weights:
    ``model.forward`` over seeded patches (8, 256, 1024) and the e2e
    prompts (8, 512), ``last_only``, on the kernel route (24 causal flash
    launches over 768 positions: the projector's 256 prefix embeddings and
    512 tokens) and the plain route (none); the last-position logits within
    ``atol``, each route timed.  Returns the kernel route's launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as model_mod
    cfg, model, prompts = ctx["cfg"], ctx["model"], ctx["prompts"]
    cfg_plain = plain_route(cfg)
    patches = torch.randn((prompts.shape[0], cfg.n_vision_tokens,
                           cfg.d_vision), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(3))
    batch = {"patches": patches, "tokens": prompts.cuda()}

    def run(c):
        with torch.no_grad():
            return model_mod.forward(c, model, batch, last_only=True)[0]

    fa.launches = 0
    got = run(cfg)
    n = fa.launches
    check(n == cfg.n_layers, f"image-prefixed forward: {n} flash launches "
          f"!= {cfg.n_layers}")
    want = run(cfg_plain)
    check(fa.launches == n, "the plain route launched flash")
    check(tuple(got.shape) == (prompts.shape[0], 1, cfg.vocab_size)
          and bool(torch.isfinite(got).all()), "forward logits")
    e = err(got, want)
    ms, plain_ms = [], []
    for c, out in ((cfg, ms), (cfg_plain, plain_ms)):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(c)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    positions = cfg.n_vision_tokens + prompts.shape[1]
    print(f"[vlm] image-prefixed forward, patches {tuple(patches.shape)} + "
          f"tokens {tuple(prompts.shape)} -> {positions} positions, last "
          f"only: {n} flash launches; "
          f"kernel route {statistics.median(ms):.2f} ms, plain route "
          f"{statistics.median(plain_ms):.2f} ms (median of 3, warm); "
          f"last-position logits max abs diff {e:.4g} (atol {atol}; max "
          f"|logit| {want.abs().max().item():.3g})")
    check(e <= atol, f"image-prefixed forward logits differ by {e} > {atol}")
    return {"flash_attention": n}


# --------------------------------------------------------------- robustness --
# the counters that must not move in any serving phase: a rung standing in
# for a kernel on the card is a failure there, not a quiet fallback
GUARD_COUNTERS = ("engine.degraded", "degrade.compile",
                  "registry.spotcheck_failed")
# the robustness phase's counters, printed on its {"robustness": ...} line
ROBUSTNESS_COUNTERS = ("faults.injected", "engine.degraded",
                       "engine.fallback_build", "serve.degraded_request",
                       "compile.measure_failed", "cache.corrupt",
                       "degrade.compile", "registry.spotcheck_failed")


def obs_counters(names) -> dict:
    """The process-wide ``obs`` counters ``names``, from a snapshot."""
    from repro_torch import obs
    snap = obs.snapshot(include_views=False)["counters"]
    return {k: snap.get(k, 0) for k in names}


@contextlib.contextmanager
def guarded(label: str, record: dict):
    """Around one serving phase: ``GUARD_COUNTERS`` must not move (read as
    deltas of ``obs.snapshot()``); the deltas go into ``record[label]``."""
    before = obs_counters(GUARD_COUNTERS)
    yield
    after = obs_counters(GUARD_COUNTERS)
    delta = {k: after[k] - before[k] for k in GUARD_COUNTERS}
    record[label] = delta
    check(not any(delta.values()),
          f"{label}: a rung stood in for a kernel on the card: {delta}")


def held_rows(toks, logits) -> dict:
    """generate's (B, n) tokens and (n, B, V) logits as
    ``hold_first_difference``'s rows: row -> (tokens, logits)."""
    return {b: (toks[b].cpu().numpy(), logits[:, b].float().cpu().numpy())
            for b in range(toks.shape[0])}


def phase_robustness(q_ctx, m_ctx) -> tuple:
    """The obs spine, the fault harness and the degradation ladder on the
    card, on the e2e phases' qwen3-0.6b and mamba2-1.3b weights: (1) qwen3
    ``generate`` traced (a Chrome trace under ``build/``, one
    ``serve.generate`` span holding one ``serve.prefill`` and 64
    ``serve.decode``; ``serve.ttft_s`` 1 sample and ``serve.decode_step_s``
    64; 28 flash and 1792 decode attention launches; no degraded step);
    (2) the instrumentation's cost: the raw ``model.decode_step`` loop,
    ``Engine.decode_token`` with tracing off and with it on, each step
    synchronized, interleaved step by step over three rounds of 64 steps
    (the engine's tracing-off median step at most 1.05x the raw loop's);
    (3) a decode
    fault at the 11th step (``engine.decode``), re-run on the plain route:
    28 flash and 63 x 28 decode attention launches, the logits within
    ``ATOL_E2E_LOGITS`` of (1)'s and the tokens identical up to a near-tie
    (``hold_first_difference``); (4) NaN from the ``ssd_decode`` plans of
    a fresh registry for mamba2 (``kernel_plan='measure'``, replaying from
    a copy of the registry phase's cache with 0 measurements, installed
    under the rules) at decode steps 6 and 7: both degraded
    (``FloatingPointError``), every logit finite, each row within
    ``ATOL_E2E_SSM_LOGITS`` of the direct route's up to a near-tie;
    (5) qwen3 warmed on a fresh registry and private cache under a
    measurement timeout and a garbage cache file: both counted, every plan
    at the ``hopper`` tier, ``generate`` within ``ATOL_E2E_LOGITS`` of the
    direct route's.  Returns the phase's launches and counter deltas."""
    import shutil
    from repro_torch import compiler, obs
    from repro_torch.compiler import CompileCache
    from repro_torch.compiler.registry import (PlanRegistry,
                                               set_default_registry)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_decode as sd
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import Engine
    from repro_torch.testing import faults
    mods = {"flash_attention": fa, "decode_attention": da, "ssd_scan": ss,
            "ssd_decode": sd}
    launches = dict.fromkeys(mods, 0)

    def counted(fn):
        for mod in mods.values():
            mod.launches = 0
        out = fn()
        got = {name: mod.launches for name, mod in mods.items()}
        for name, n in got.items():
            launches[name] += n
        return out, got

    cfg, model, scfg = q_ctx["cfg"], q_ctx["model"], q_ctx["scfg"]
    prompts, n_new = q_ctx["prompts"], q_ctx["toks"].shape[1]
    layers = cfg.n_layers
    c0 = obs_counters(ROBUSTNESS_COUNTERS)

    # (1) qwen3 traced
    eng = Engine(cfg, model, scfg)
    tr = obs.Tracer(enabled=True)
    old_tr = obs.set_tracer(tr)
    hist = obs.default_metrics().histogram
    h0 = (hist("serve.ttft_s").count, hist("serve.decode_step_s").count)
    d0 = obs_counters(GUARD_COUNTERS)
    try:
        (toks, logits), got = counted(
            lambda: eng.generate(prompts, n_new, return_logits=True))
    finally:
        obs.set_tracer(old_tr)
    path = BUILD_CACHE.parent / "robustness_trace.json"
    tr.write(path, metadata={"arch": cfg.name, "batch": scfg.batch,
                             "prompt_len": prompts.shape[1],
                             "n_new": n_new})
    trace = json.loads(path.read_text())
    gens = tr.spans("serve.generate")
    pre = [r for r in tr.spans("serve.prefill")
           if r["parent"] == "serve.generate"]
    dec = [r for r in tr.spans("serve.decode")
           if r["parent"] == "serve.generate"]
    n_ttft = hist("serve.ttft_s").count - h0[0]
    n_step = hist("serve.decode_step_s").count - h0[1]
    degraded = obs_counters(GUARD_COUNTERS)["engine.degraded"] \
        - d0["engine.degraded"]
    print(f"[robustness] qwen3 traced: {len(trace['traceEvents'])} trace "
          f"events in {path.relative_to(BUILD_CACHE.parents[1])}; spans "
          f"serve.generate {len(gens)}, serve.prefill {len(pre)}, "
          f"serve.decode {len(dec)}; serve.ttft_s +{n_ttft}, "
          f"serve.decode_step_s +{n_step}; launches {got}; engine.degraded "
          f"+{degraded}")
    check(len(gens) == 1 and len(pre) == 1 and len(dec) == n_new,
          "traced generate's spans")
    check(n_ttft == 1 and n_step == n_new, "traced generate's histograms")
    check(got["flash_attention"] == layers
          and got["decode_attention"] == layers * n_new,
          f"traced generate's launches {got}")
    check(degraded == 0, "the traced generate degraded a step")

    # (2) the instrumentation's cost: raw loop, engine off, engine on,
    # interleaved step by step (each on its own cache, the order rotated
    # every step), so the host's drift reaches all three alike
    def raw(cache, cur):
        return model_mod.decode_step(cfg, model, {"tokens": cur}, cache)

    steps = {"raw": raw, "off": eng.decode_token, "on": eng.decode_token}
    tracers = {"raw": obs.Tracer(), "off": obs.Tracer(),
               "on": obs.Tracer(enabled=True)}
    samples = {label: [] for label in steps}

    def interleaved():
        labels = list(steps)
        for _ in range(3):
            state = {}
            for label in labels:
                cache, last = eng.prefill(prompts)
                state[label] = (cache, last.argmax(-1)[:, None])
            for i in range(n_new):
                for label in labels[i % 3:] + labels[:i % 3]:
                    cache, cur = state[label]
                    old_tr = obs.set_tracer(tracers[label])
                    try:
                        t0 = time.perf_counter()
                        logits, cache = steps[label](cache, cur)
                        torch.cuda.synchronize()
                        samples[label].append(time.perf_counter() - t0)
                    finally:
                        obs.set_tracer(old_tr)
                    state[label] = (cache, logits[:, -1].argmax(-1)[:, None])

    with torch.no_grad():
        counted(interleaved)
    ms = {k: statistics.median(v) * 1e3 for k, v in samples.items()}
    mean = {k: statistics.fmean(v) * 1e3 for k, v in samples.items()}
    print(f"[robustness] decode step, qwen3 B 8 (median of 3 x {n_new} "
          f"synchronized steps each, interleaved): raw model.decode_step "
          f"{ms['raw']:.3f} ms, Engine.decode_token tracing off "
          f"{ms['off']:.3f} ms ({ms['off'] / ms['raw']:.4f}x), tracing on "
          f"{ms['on']:.3f} ms ({ms['on'] / ms['raw']:.4f}x); means "
          f"{mean['raw']:.3f} / {mean['off']:.3f} / {mean['on']:.3f} ms; "
          f"{len(tracers['on'].spans('serve.decode'))} serve.decode spans "
          f"traced")
    check(ms["off"] <= 1.05 * ms["raw"],
          f"tracing-off engine step {ms['off']:.3f} ms > 1.05 x the raw "
          f"loop's {ms['raw']:.3f} ms")

    # (3) a mid-request decode fault
    rule = faults.FaultRule("engine.decode", "error", after=10, times=1)
    f0 = obs_counters(ROBUSTNESS_COUNTERS)
    with faults.inject(rule):
        (f_toks, f_logits), got = counted(
            lambda: eng.generate(prompts, n_new, return_logits=True))
    f1 = obs_counters(ROBUSTNESS_COUNTERS)
    fd = {k: f1[k] - f0[k] for k in ROBUSTNESS_COUNTERS}
    step_ms = [x * 1e3 for x in eng.timer.steady["decode"][-n_new:]]
    clean_ms = statistics.median(step_ms[:10] + step_ms[11:])
    print(f"[robustness] qwen3 decode fault at step 11: {fd}; launches "
          f"{got}; degraded requests {eng.degraded_requests}; the degraded "
          f"step {step_ms[10]:.3f} ms (plain route, NaN guard on) against "
          f"{clean_ms:.3f} ms median of the other steps")
    check(rule.fired == 1 and fd["faults.injected"] == 1
          and fd["engine.degraded"] == 1 and fd["engine.fallback_build"] == 1
          and eng.degraded_requests == 1, f"decode fault counters {fd}")
    check(got["flash_attention"] == layers
          and got["decode_attention"] == layers * (n_new - 1),
          f"decode fault launches {got}")
    step_err = err(f_logits[11], logits[11])
    same, worst = hold_first_difference(
        "qwen3 decode fault vs fault-free", held_rows(f_toks, f_logits),
        held_rows(toks, logits), ATOL_E2E_LOGITS)
    print(f"[robustness] the degraded step's logits within {step_err:.4g} "
          f"of the fault-free run's (atol {ATOL_E2E_LOGITS}); {same}/"
          f"{scfg.batch} rows' tokens identical, logits within {worst:.4g}")
    check(step_err <= ATOL_E2E_LOGITS, "the degraded step's logits")

    # (4) a poisoned kernel in mamba2's serving loop
    mcfg = dataclasses.replace(m_ctx["cfg"], kernel_plan="measure")
    m_layers = mcfg.n_layers
    reg_copy = BUILD_CACHE / "robustness_registry_cache.json"
    shutil.copyfile(REGISTRY_CACHE, reg_copy)
    compiler.clear_memo()
    reg = PlanRegistry(cache=CompileCache(reg_copy))
    # decode steps 6 and 7 (each calls the SSD decode plan once a layer):
    # the reference's after=5, times=2 counted in steps
    rules = [faults.FaultRule("registry.exec", "nan",
                              match={"kernel": "ssd_decode"},
                              after=m_layers * k, times=1) for k in (5, 6)]
    tr = obs.Tracer(enabled=True)
    old_tr, old_reg = obs.set_tracer(tr), set_default_registry(reg)
    f0 = obs_counters(ROBUSTNESS_COUNTERS)
    try:
        with faults.inject(*rules):
            m_eng = Engine(mcfg, m_ctx["model"], m_ctx["scfg"])
            (p_toks, p_logits), got = counted(lambda: m_eng.generate(
                m_ctx["prompts"], n_new, return_logits=True))
    finally:
        obs.set_tracer(old_tr)
        set_default_registry(old_reg)
    f1 = obs_counters(ROBUSTNESS_COUNTERS)
    fd = {k: f1[k] - f0[k] for k in ROBUSTNESS_COUNTERS}
    st = m_eng.stats()
    reasons = [r["args"].get("reason") for r in tr.records
               if r["type"] == "event" and r["name"] == "engine.degraded"]
    print(f"[robustness] mamba2 NaN ssd_decode plans at decode steps 6 and "
          f"7: warmup {st['plans_warmed']} plans, {st['warmup_measured']} "
          f"measured; {fd}; reasons {reasons}; launches {got} (each "
          f"poisoned step launches its {m_layers} before the guard reads "
          f"its logits; the re-runs launch none)")
    check(st["warmup_measured"] == 0 and st["warmup_failed"] == 0,
          "the mamba2 registry did not replay")
    check(all(r.fired == 1 for r in rules) and fd["engine.degraded"] == 2
          and reasons == ["FloatingPointError"] * 2
          and m_eng.degraded_requests == 1, f"poisoned-kernel counters {fd}")
    check(bool(torch.isfinite(p_logits).all()), "a NaN reached the logits")
    check(got["ssd_scan"] == m_layers
          and got["ssd_decode"] == m_layers * n_new,
          f"poisoned-kernel launches {got}")
    same, worst = hold_first_difference(
        "mamba2 poisoned vs fault-free", held_rows(p_toks, p_logits),
        held_rows(m_ctx["toks"], m_ctx["logits"]), ATOL_E2E_SSM_LOGITS)
    print(f"[robustness] mamba2 poisoned vs the direct route: {same}/"
          f"{scfg.batch} rows' tokens identical, logits within {worst:.4g} "
          f"(atol {ATOL_E2E_SSM_LOGITS})")

    # (5) a compile-side fault
    priv = BUILD_CACHE / "robustness_compile_cache.json"
    priv.unlink(missing_ok=True)
    compiler.clear_memo()
    reg = PlanRegistry(cache=CompileCache(priv))
    old_reg = set_default_registry(reg)
    f0 = obs_counters(ROBUSTNESS_COUNTERS)
    try:
        with faults.inject(
                faults.FaultRule("compile.measure", "timeout", times=1),
                faults.FaultRule("cache.json", "garbage")):
            c_eng = Engine(dataclasses.replace(cfg, kernel_plan="measure"),
                           model, scfg)
            (c_toks, c_logits), got = counted(lambda: c_eng.generate(
                prompts, n_new, return_logits=True))
    finally:
        set_default_registry(old_reg)
    f1 = obs_counters(ROBUSTNESS_COUNTERS)
    fd = {k: f1[k] - f0[k] for k in ROBUSTNESS_COUNTERS}
    tiers = {k.backend for k in reg._plans.values()}
    print(f"[robustness] qwen3 registry under a measurement timeout and a "
          f"garbage cache file: {fd}; {len(reg._plans)} plans, backends "
          f"{sorted(tiers)}, launches {got}")
    check(fd["compile.measure_failed"] >= 1 and fd["cache.corrupt"] >= 1,
          f"compile-side fault counters {fd}")
    check(tiers == {"hopper"} and all(
        r["tiers"] == ["hopper"] for r in c_eng.warmup_report),
        "a plan left the hopper tier")
    check(fd["degrade.compile"] == 0 and fd["engine.degraded"] == 0,
          f"compile-side fault degraded {fd}")
    check(got["flash_attention"] == layers
          and got["decode_attention"] == layers * n_new,
          f"compile-side fault launches {got}")
    same, worst = hold_first_difference(
        "qwen3 registry under compile faults vs direct",
        held_rows(c_toks, c_logits), held_rows(toks, logits),
        ATOL_E2E_LOGITS)
    print(f"[robustness] qwen3 registry under compile faults vs the direct "
          f"route: {same}/{scfg.batch} rows' tokens identical, logits "
          f"within {worst:.4g} (atol {ATOL_E2E_LOGITS})")

    c1 = obs_counters(ROBUSTNESS_COUNTERS)
    counters = {k: c1[k] - c0[k] for k in ROBUSTNESS_COUNTERS}
    print(f"[robustness] the phase's counters: {counters}; launches "
          f"{launches}")
    return {k: n for k, n in launches.items() if n}, counters


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
    # every compile-cache entry of this run (pump='auto' / 'measure'
    # included) stays in the checkout
    os.environ.setdefault("REPRO_TORCH_CACHE_DIR", str(BUILD_CACHE))
    from repro_torch.launch.serve import moe_ragged
    from repro_torch.launch.timing import Timer
    t_start = time.perf_counter()
    card = phase_env()
    with timed("build"):
        phase_build()
    timer = Timer()
    with timed("kernels against their plain versions (3 a-i)"):
        kernels = (phase_kernels(timer) + phase_ssd_kernels(timer)
                   + phase_paper_kernels(timer) + phase_grouped_gemm(timer))
    with timed("the new configs' kernel shapes (3 k)"):
        phase_serving_shapes(timer, kernels)
    with timed("the stream's kernel shapes (3 l)"):
        phase_stream_shapes(timer, kernels)
    with timed("whisper-base and internvl2-2b's kernel shapes (3 m)"):
        phase_encdec_vlm_shapes(timer, kernels)
    with timed("compiler (3 j)"):
        compiled, compiler_launches = phase_compiler(timer)
    kernels += compiled
    del timer
    # each path's launches, read around its own run: path -> kernel -> count
    paths = {}
    # the plan registry phase's measured plans go to a cache of their own
    from repro_torch.compiler import CompileCache
    from repro_torch.compiler.registry import PlanRegistry
    REGISTRY_CACHE.unlink(missing_ok=True)
    registry = PlanRegistry(cache=CompileCache(REGISTRY_CACHE))
    qwen3 = ({"flash_attention": 28}, {"decode_attention": 28},
             ATOL_E2E_LOGITS)
    qwen3_plain = set_field(attention_impl="xla_chunked")
    # each serving phase's engine.degraded, degrade.compile and
    # registry.spotcheck_failed deltas: all must be 0
    guard = {}
    with timed("qwen3-0.6b"):
        with guarded("qwen3-0.6b", guard):
            paths["qwen3-0.6b"], q_ctx = phase_e2e(
                "qwen3-0.6b", ("pallas", set_field(attention_impl="pallas")),
                ("xla_chunked", qwen3_plain), *qwen3)
        with guarded("qwen3-0.6b registry", guard):
            phase_registry(q_ctx, *qwen3, registry)
        served = [(q_ctx["cfg"], q_ctx["scfg"])]
        with timed("qwen3-0.6b stream"), guarded("qwen3-0.6b stream", guard):
            stream = phase_stream_qwen3(q_ctx, qwen3_plain)
        phase_decode_loop()
    mamba2 = ({"ssd_scan": 48}, {"ssd_decode": 48}, ATOL_E2E_SSM_LOGITS)
    mamba2_plain = set_field(ssm_impl="xla")
    with timed("mamba2-1.3b"):
        with guarded("mamba2-1.3b", guard):
            paths["mamba2-1.3b"], m_ctx = phase_e2e(
                "mamba2-1.3b", ("pallas", set_field(ssm_impl="pallas")),
                ("xla", mamba2_plain), *mamba2)
        with guarded("mamba2-1.3b registry", guard):
            phase_registry(m_ctx, *mamba2, registry)
        served.append((m_ctx["cfg"], m_ctx["scfg"]))
        with timed("mamba2-1.3b stream"), \
                guarded("mamba2-1.3b stream", guard):
            stream.update(phase_stream_mamba2(m_ctx, mamba2_plain))
        paths["stream"] = stream
    with timed("robustness (8)"):
        paths["robustness"], robust = phase_robustness(q_ctx, m_ctx)
    del q_ctx, m_ctx
    # zamba2: 54 Mamba-2 blocks in 9 groups of 6, each group followed by
    # the one shared attention block: 54 scans and 9 flash launches a
    # prefill, 54 SSD decode steps and 9 decode attentions a step
    zamba2 = ({"ssd_scan": 54, "flash_attention": 9},
              {"ssd_decode": 54, "decode_attention": 9},
              ATOL_E2E_HYBRID_LOGITS)
    with timed("zamba2-2.7b"), guarded("zamba2-2.7b", guard):
        paths["zamba2-2.7b"], ctx = phase_e2e(
            "zamba2-2.7b",
            ("pallas", set_field(attention_impl="pallas", ssm_impl="pallas")),
            ("xla_chunked / xla", set_field(attention_impl="xla_chunked",
                                            ssm_impl="xla")),
            *zamba2, profile=True)
        phase_registry(ctx, *zamba2, registry)
        served.append((ctx["cfg"], ctx["scfg"]))
        del ctx
    with timed("registry replay"), guarded("registry replay", guard):
        phase_registry_replay(served, lambda: CompileCache(REGISTRY_CACHE))
    with timed("deepseek-v2-lite-16b"), \
            guarded("deepseek-v2-lite-16b", guard):
        paths["deepseek-v2-lite-16b"], _ctx = phase_e2e(
            "deepseek-v2-lite-16b", ("ragged grouped GEMM", moe_ragged),
            ("dense dropless", plain_moe),
            {"grouped_gemm": 78}, {"grouped_gemm": 78}, ATOL_E2E_MOE_LOGITS)
        del _ctx
    with timed("qwen2.5-14b"), guarded("qwen2.5-14b", guard):
        paths["qwen2.5-14b"], _ctx = phase_e2e(
            "qwen2.5-14b", ("pallas", set_field(attention_impl="pallas")),
            ("xla_chunked", set_field(attention_impl="xla_chunked")),
            {"flash_attention": 48}, {"decode_attention": 48},
            ATOL_E2E_QWEN25_LOGITS, profile=True)
        del _ctx
    with timed("whisper-base"), guarded("whisper-base", guard):
        paths["whisper-base"] = phase_whisper(ATOL_E2E_WHISPER_LOGITS)
    with timed("internvl2-2b"), guarded("internvl2-2b", guard):
        vlm_plain = set_field(attention_impl="xla_chunked")
        paths["internvl2-2b"], ctx = phase_e2e(
            "internvl2-2b", ("pallas", set_field(attention_impl="pallas")),
            ("xla_chunked", vlm_plain), {"flash_attention": 24},
            {"decode_attention": 24}, ATOL_E2E_INTERNVL2_LOGITS,
            profile=True)
        forward = phase_vlm_forward(ctx, vlm_plain,
                                    ATOL_E2E_INTERNVL2_LOGITS)
        for name, n in forward.items():
            paths["internvl2-2b"][name] = paths["internvl2-2b"].get(
                name, 0) + n
        del ctx
    with timed("deepseek-v3-671b, cut depth"), \
            guarded("deepseek-v3-671b cut", guard):
        print(f"[e2e] deepseek-v3-671b at full width, cut from 61 layers to "
              f"{DSV3_LAYERS} (its 3 dense layers and {DSV3_LAYERS - 3} MoE "
              f"layers; 671 B parameters do not fit one card); the plain "
              f"route held at 8 x {DSV3_HOLD_PROMPT} prompt tokens")
        paths["deepseek-v3-671b"], _ctx = phase_e2e(
            "deepseek-v3-671b", ("ragged grouped GEMM", dsv3_cut),
            ("dense dropless", plain_moe),
            {"grouped_gemm": 3 * (DSV3_LAYERS - 3)},
            {"grouped_gemm": 3 * (DSV3_LAYERS - 3)}, ATOL_E2E_MOE_LOGITS,
            hold_prompt=DSV3_HOLD_PROMPT, moe_registry=False, profile=True)
        del _ctx
    with timed("paper tables"):
        paths["paper"] = phase_paper()
    paths["compiler"] = compiler_launches
    print(json.dumps({"robustness": {
        "counters": robust, "launches": paths["robustness"],
        "guard": guard}}))
    for entry in kernels:
        by_path = {path: n[entry["name"]] for path, n in paths.items()
                   if n.get(entry["name"])}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    print(f"[done] {time.perf_counter() - t_start:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
