"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload qwen2-7b.code --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout that holds ``src/repro_torch``, on a machine
with the cell's CUDA cards.  The last line of standard output is the
result as one JSON object; the last lines of standard error give each
number compared beside its limit.  Caches (the compile cache, kernel
builds) live under ``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BUILD = CHECKOUT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 3.0     # the traced stretch after the window (--trace 1)


def set_paths() -> None:
    """Caches inside the checkout at fixed paths; the program and the
    harness importable."""
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(BUILD / "compile_cache")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (str(CHECKOUT), str(CHECKOUT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name, compared whole,
    is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def host_probe() -> float:
    """Milliseconds of a fixed piece of pure-Python work: the host's speed
    as this process sees it, printed beside each window (the host paces
    the loop, and its speed varies between runs)."""
    t = time.perf_counter()
    n = 0
    for i in range(300_000):
        n += i & 7
    return (time.perf_counter() - t) * 1e3


def applicable(metrics, workload: str):
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


def run_cell(files, bench, seed: int, seconds: float, traced: bool,
             device, t_start: float, log) -> dict:
    import gc

    import torch

    from portbench.harness import check
    from portbench.harness.cell import Cell, reference_gap
    from portbench.harness.trace import load_module

    cuda = device.type == "cuda"
    workload = files["cell"]["name"]
    mix = files["mix"]
    # one host thread for the program's CPU-side tensor work: the host
    # paces the loop, and a pool of threads spinning beside it varies
    torch.set_num_threads(1)
    cell = Cell(files, seed, device)
    cell.build()
    cell.start()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    reg0 = cell.registry_stats()
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    degraded0 = cell.engine.degraded_requests
    # what set-up made lives to the end: out of the collector's way
    gc.collect()
    gc.freeze()
    probe0 = host_probe()
    w = cell.window(seconds, timed=traced)
    log(f"host probe before / after the window: {probe0:.2f} / "
        f"{host_probe():.2f} ms")
    w.setup_s = setup_s
    w.peak_window_bytes = (torch.cuda.max_memory_allocated(device)
                           if cuda else 0)
    if traced:
        w.trace = cell.traced(TRACE_SECONDS,
                              BUILD / f"trace-{workload}.json", log)
    reg1 = cell.registry_stats()
    if reg0 is not None:
        log(f"registry during the window: "
            f"{reg1['misses'] - reg0['misses']} misses, "
            f"{reg1['fallbacks'] - reg0['fallbacks']} fallbacks "
            f"(set-up: {reg0['misses']} misses)")
    failed = cell.engine.degraded_requests - degraded0
    mem_peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) \
        if cuda else 0
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in applicable(bench[kind], workload):
        v = load_module("metrics", m["name"]).read(w)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        else:
            log(f"metric {m['name']}: nothing to read")
    s = check.sample(w.completed(), seed, int(mix["sample"]["requests"]),
                     int(mix["sample"]["tokens"]))
    attempted = w.attempted()
    log(f"window {w.seconds:.3f} s, {len(w.steps)} steps, "
        f"{len(w.completed())} requests finished; sample "
        f"{len(s)} requests, {sum(len(r.tokens) for r in s)} tokens")
    cell.release()
    limits = files["limits"]["compare"]
    got = reference_gap(cell, s) if s else {k: math.inf for k in limits}
    correct = bool(s) and all(got[k] <= v for k, v in limits.items())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(files["cell"]["chips"]),
           "memory_peak_bytes": int(mem_peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = w.trace["busy_s"]
        dev["window_s"] = w.trace["window_s"]
        out["breakdown"] = {"device_ops": w.trace["device_ops"],
                            "idle_gaps": w.trace["idle_gaps"]}
        out["launches"] = w.trace["launches"]
    log(f"compared {got.get('tokens', 0)} served tokens of "
        f"{got.get('requests', 0)} requests")
    out["checks"] = {k: {"value": got[k], "limit": v}
                     for k, v in limits.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_paths()
    from portbench.harness.cell import bench_file, cell_files, log

    bench = bench_file()
    files = cell_files(args.workload, bench)
    import torch
    need = int(files["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"{args.workload} needs {need} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(files, bench, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START, log)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures the port alone")
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
