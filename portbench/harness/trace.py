"""The traced stretch: ``torch.profiler`` over a few seconds of the loop
after the window, reduced to the device's busy time, kernel time by name,
the longest idle gaps by what the host was doing, and each kernel's share
of its roofline."""
from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.traced"
# a gap shorter than this is the launch spacing between kernels
GAP_US = 20.0

ROOT = Path(__file__).resolve().parents[1]


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, found by the name the benchmark
    gives it."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_trace(path: Path) -> Dict:
    """busy_s, window_s, kernel seconds and counts by name, device_ops and
    idle_gaps from a Chrome trace of the traced stretch."""
    events = json.loads(path.read_text())["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no traced-window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    dev: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            by_name[e["name"]] += (b - a) * 1e-6
            count[e["name"]] += 1
        elif cat in HOST_CATS and e.get("tid") == tid and a >= w0 - 1e6:
            host.append((a, b, e["name"], cat))
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    labels = [h for h in host if h[3] == "user_annotation"
              and h[2].startswith("portbench.") and h[2] != WINDOW]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        if b - a < GAP_US:
            gaps["between kernels (gaps under 20 us)"] += (b - a) * 1e-6
            continue
        mid = 0.5 * (a + b)
        cover = [h for h in labels if h[0] <= mid <= h[1]]
        outer = max(cover)[2] if cover else "scheduler, outside the engine"
        inner = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 4000), -1):
            h = host[j]
            if h[1] >= mid and h[3] != "user_annotation":
                inner = h[2]
                break
        gaps[outer + (" / " + inner if inner else "")] += (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "kernel_s": dict(by_name), "kernel_n": dict(count),
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def roofline(port: Dict, steps, reduced: Dict, kernels: List[str],
             launches: Dict[str, int], peaks: Dict, warn) -> Dict[str, float]:
    """Each kernel's share of its roofline over the traced steps: sum of
    max(FLOPs / peak, bytes / bandwidth) over its calls, over its device
    seconds.  A kernel whose calls, as the work counts them, the trace's
    kernels and the program's launch counter disagree on, reads nothing."""
    out: Dict[str, float] = {}
    for k in kernels:
        mod = load_module("roofline", k)
        calls = mod.calls(port, steps)
        n_work = sum(c[0] for c in calls)
        pat = re.compile(mod.PATTERN)
        secs = sum(s for n, s in reduced["kernel_s"].items() if pat.search(n))
        n_trace = sum(c for n, c in reduced["kernel_n"].items()
                      if pat.search(n))
        n_prog = launches.get(mod.COUNTER)
        if not (n_work == n_trace == n_prog) or not n_work or secs <= 0:
            warn(f"roofline {k}: calls by the work {n_work}, in the trace "
                 f"{n_trace}, by the launch counter {n_prog}; "
                 f"{secs:.6f} s of kernel time; not read")
            continue
        bound = sum(n * max(fl / peaks[pk], nb / peaks["bytes_per_s"])
                    for n, fl, nb, pk in calls)
        out[k] = 100.0 * bound / secs
    return out


def launch_counts(names: List[str]) -> Dict[str, int]:
    """The program's launch counters (``repro_torch.kernels.<name>
    .launches``) of the given kernel modules."""
    out = {}
    for n in names:
        mod = importlib.import_module(f"repro_torch.kernels.{n}")
        out[n] = int(getattr(mod, "launches", 0))
    return out


def counters_of(kernels: List[str]) -> List[str]:
    return [load_module("roofline", k).COUNTER for k in kernels]
